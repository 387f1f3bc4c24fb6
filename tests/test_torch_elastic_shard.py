"""PyTorch port vs the JAX reference: the sharded, batched fold.

Each case mirrors one of ``tests/test_elastic_shard.py`` (and the
property of ``tests/test_elastic_shard_property.py``, with few
examples): the port's sharded service must equal the port's sequential
fold fed client-sorted arrivals bit for bit, outputs and per-client
RX/retransmit accounting alike, and the reference's sharded service on
the same numpy gradients: dyadic streams bit for bit, Gaussian ones
within ``rtol=1e-5, atol=1e-6`` (the two frameworks' sketch sums round
apart), integer sketches, words, exponents, tilings, telemetry and
``OverflowError`` texts exactly. The JAX side runs as its own tests run
it on the CPU; its imports stay inside the tests.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bucketing import make_bucket_plan
from repro_torch.core.config import CompressionConfig
from repro_torch.elastic import (AdmissionPolicy, ClientPayload, ElasticClient,
                                 ElasticServer, FoldEngine, FoldError,
                                 ShardedFoldService, StaleContractError,
                                 negotiate_contract, shard_contract,
                                 shard_ranges, stripe_payload)
from repro_torch.elastic.fold import _recover_fn
from repro_torch.ft.failures import FailureSimulator, SwitchRetransmitPolicy
from repro_torch.net.fixedpoint import FixedPointWire
from repro_torch.net.switch import SwitchModel

CFG = CompressionConfig(ratio=1.0, lanes=128, rows=6, rounds=10,
                        chunk_blocks=8, topk_ratio=0.1, topk_exact=True,
                        error_feedback=True, bucket_bytes=2 * 768 * 4)
CFG_FX = dataclasses.replace(CFG, wire_dtype="fxp32")
# 9000 elems -> 6 buckets of 1536: enough range for real shard sweeps
SHAPES = {"a": (7000,), "b": (50, 40)}
TEMPLATE = {k: np.zeros(sh, np.float32) for k, sh in SHAPES.items()}
CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side runs on one intra-op thread: its tensors are small,
    and the suite's parallel workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The reference's elastic service."""
    from repro.core.bucketing import make_bucket_plan as j_plan
    from repro.core.config import CompressionConfig as JConfig
    from repro import elastic
    from repro.ft import failures
    cfg = JConfig(**dataclasses.asdict(CFG))
    return types.SimpleNamespace(
        el=elastic, ft=failures, plan=j_plan, cfg=cfg,
        cfg_fx=dataclasses.replace(cfg, wire_dtype="fxp32"))


def dyadic_tree(seed):
    """sign * 2^e values: every summation order is exact."""
    r = np.random.default_rng(seed)
    out = {}
    for k, sh in SHAPES.items():
        n = int(np.prod(sh))
        g = np.zeros(n, np.float32)
        idx = r.choice(n, size=max(1, n // 3), replace=False)
        g[idx] = (r.choice([-1.0, 1.0], size=idx.size)
                  * np.exp2(r.integers(-2, 3, size=idx.size))
                  ).astype(np.float32)
        out[k] = g.reshape(sh)
    return out


def gauss_tree(seed):
    r = np.random.default_rng(seed)
    return {k: (r.normal(size=sh) * np.pi).astype(np.float32)
            for k, sh in SHAPES.items()}


def _plan(cfg=CFG):
    return make_bucket_plan([TEMPLATE[k] for k in sorted(TEMPLATE)], cfg)


def jcfg(J, cfg):
    return J.cfg_fx if cfg.wire_dtype == "fxp32" else J.cfg


def shard_rows(report):
    """``per_shard_report`` rows without their host-clock seconds."""
    return [{k: v for k, v in row.items() if not k.endswith("_s")}
            for row in report]


# ----------------------------------------------------------------------
# Tiling + striping
# ----------------------------------------------------------------------

def test_shard_ranges_balanced_contiguous_tiling(J):
    rs = shard_ranges(10, 3)
    assert [(r.start, r.count) for r in rs] == [(0, 4), (4, 3), (7, 3)]
    assert rs[0].stop == rs[1].start and rs[1].stop == rs[2].start
    assert rs[-1].stop == 10
    assert shard_ranges(4, 4) == shard_ranges(4, 4)
    for nb, s in [(10, 3), (7, 7), (425, 4), (1, 1), (9, 2)]:
        assert [dataclasses.astuple(r) for r in shard_ranges(nb, s)] == \
            [dataclasses.astuple(r) for r in J.el.shard_ranges(nb, s)]
    with pytest.raises(ValueError, match=">= 1"):
        shard_ranges(4, 0)
    with pytest.raises(ValueError, match="at least one bucket"):
        shard_ranges(3, 4)


def test_shard_contract_truncates_like_group_view(J):
    plan = _plan()
    contract = negotiate_contract(0, range(3), plan, CFG)
    jplan = J.plan(TEMPLATE, J.cfg)
    jc = J.el.negotiate_contract(0, range(3), jplan, J.cfg)
    rs = shard_ranges(contract.n_buckets, 3)
    for r, jr in zip(rs, J.el.shard_ranges(jc.n_buckets, 3)):
        a = shard_contract(contract, r, plan)
        b = shard_contract(contract, r)
        assert (a.n_buckets, a.total_elems) == (b.n_buckets, b.total_elems)
        assert a.total_elems == plan.group_view(r.start, r.count).total
        assert a.contract_id == J.el.shard_contract(jc, jr, jplan).contract_id
    assert sum(shard_contract(contract, r).total_elems for r in rs) \
        == contract.total_elems


def test_stripe_payload_is_exact_and_lossless(J):
    contract = negotiate_contract(0, range(2), _plan(), CFG)
    payload = ElasticClient(0, CFG, device=CPU).contribute(contract,
                                                           dyadic_tree(7))
    jc = J.el.negotiate_contract(0, range(2), J.plan(TEMPLATE, J.cfg), J.cfg)
    jpay = J.el.ElasticClient(0, J.cfg).contribute(jc, dyadic_tree(7))
    bpb = contract.bucket_elems // CFG.block_elems
    wpb = contract.bucket_elems // 32
    for S in (1, 2, 3, contract.n_buckets):
        rs = shard_ranges(contract.n_buckets, S)
        subs = stripe_payload(payload, contract, rs, bpb, wpb)
        jsubs = J.el.stripe_payload(jpay, jc, J.el.shard_ranges(jc.n_buckets, S),
                                    bpb, wpb)
        assert len(subs) == S
        # zero-copy views of the payload
        storage = payload.sketch.untyped_storage().data_ptr()
        assert all(s.sketch.untyped_storage().data_ptr() == storage
                   for s in subs)
        assert torch.equal(torch.cat([s.sketch for s in subs]), payload.sketch)
        assert torch.equal(torch.cat([s.index_words for s in subs]),
                           payload.index_words)
        assert sum(s.nbytes for s in subs) == payload.nbytes
        for s, j in zip(subs, jsubs):
            assert s.nbytes == j.nbytes
            np.testing.assert_array_equal(s.sketch.numpy(), np.asarray(j.sketch))
            np.testing.assert_array_equal(s.index_words.numpy().view(np.uint32),
                                          np.asarray(j.index_words))


def test_client_side_striping_matches_server_striping():
    contract = negotiate_contract(0, range(2), _plan(), CFG)
    client = ElasticClient(0, CFG, device=CPU)
    client.propose(contract, dyadic_tree(9))
    full = client.payload(contract)
    stripes = client.payload_stripes(contract, 3)
    server_side = stripe_payload(
        full, contract, shard_ranges(contract.n_buckets, 3),
        contract.bucket_elems // CFG.block_elems,
        contract.bucket_elems // 32)
    for a, b in zip(stripes, server_side):
        assert a.client == b.client and a.contract_id == b.contract_id
        assert torch.equal(a.sketch, b.sketch)
        assert torch.equal(a.index_words, b.index_words)


# ----------------------------------------------------------------------
# The parity pin: sharded+batched == sequential, bit for bit
# ----------------------------------------------------------------------

def _round(el, cfg, cohort, n_shards, batch_size, perm, delays, trees,
           seq=True, device=None):
    """One round through the sharded service (and the sequential engine
    fed client-sorted arrivals, ``seq``) of package ``el``."""
    kw = {} if device is None else {"device": device}
    plan = el.plan(TEMPLATE, cfg)
    contract = el.negotiate_contract(0, cohort, plan, cfg)
    clients = {c: el.ElasticClient(c, cfg, **kw) for c in cohort}
    svc = el.ShardedFoldService(contract, cfg, n_shards=n_shards,
                                batch_size=batch_size, plan=plan, **kw)
    eng = el.FoldEngine(contract, cfg, **kw) if seq else None
    st_sh = svc.init_state()
    st_seq = eng.init_state() if seq else None
    if cfg.wire_dtype == "fxp32":
        for i, c in enumerate(cohort):
            p = clients[c].propose(contract, trees[i])
            svc.propose_exponents(st_sh, c, p.exponents)
            if seq:
                eng.propose_exponents(st_seq, c, p.exponents)
        sealed = svc.seal_exponents(st_sh)
        if seq:
            assert el.equal(sealed, eng.seal_exponents(st_seq))
        payloads = {c: clients[c].payload(contract, sealed) for c in cohort}
    else:
        payloads = {c: clients[c].contribute(contract, trees[i])
                    for i, c in enumerate(cohort)}
    pols = [el.Policy(timeout_s=0.05, max_retries=64) for _ in range(2)]
    if seq:
        for c in sorted(cohort):
            eng.fold(st_seq, payloads[c], arrival_s=delays[c], policy=pols[0])
    for c in perm:
        svc.fold(st_sh, payloads[c], arrival_s=delays[c], policy=pols[1])
    return types.SimpleNamespace(svc=svc, eng=eng, st_sh=st_sh, st_seq=st_seq,
                                 payloads=payloads, pol=pols[1],
                                 contract=contract)


def port_el():
    import repro_torch.elastic as el
    return types.SimpleNamespace(
        plan=lambda t, cfg: make_bucket_plan([t[k] for k in sorted(t)], cfg),
        negotiate_contract=el.negotiate_contract, ElasticClient=el.ElasticClient,
        ShardedFoldService=el.ShardedFoldService, FoldEngine=el.FoldEngine,
        Policy=SwitchRetransmitPolicy, equal=torch.equal)


def jax_el(J):
    return types.SimpleNamespace(
        plan=J.plan, negotiate_contract=J.el.negotiate_contract,
        ElasticClient=J.el.ElasticClient,
        ShardedFoldService=J.el.ShardedFoldService,
        FoldEngine=J.el.FoldEngine, Policy=J.ft.SwitchRetransmitPolicy,
        equal=np.array_equal)


def _check_pair(J, cfg, cohort, n_shards, batch_size, perm, delays, trees,
                exact):
    """The port's sharded round equals its sequential one bit for bit,
    and the reference's sharded round (``exact``: bit for bit)."""
    p = _round(port_el(), cfg, cohort, n_shards, batch_size, perm, delays,
               trees, device=CPU)
    j = _round(jax_el(J), jcfg(J, cfg), cohort, n_shards, batch_size, perm,
               delays, trees, seq=False)
    out_seq, out_sh = p.eng.finalize(p.st_seq), p.svc.finalize(p.st_sh)
    assert torch.equal(out_seq, out_sh)
    assert p.st_seq.rx_bytes == p.st_sh.rx_bytes
    assert p.st_seq.retransmits == p.st_sh.retransmits
    assert p.st_seq.contributions == p.st_sh.contributions
    assert p.st_sh.occupancy_peak <= p.svc.window_slots
    c0 = cohort[0]
    assert torch.equal(p.eng.decode_payload(p.payloads[c0]),
                       p.svc.decode_payload(p.payloads[c0]))
    # the reference's sharded round on the same gradients
    jout = j.svc.finalize(j.st_sh)
    assert (p.st_sh.rx_bytes, p.st_sh.retransmits, p.st_sh.windows,
            p.st_sh.occupancy_peak, p.st_sh.flushes) == \
        (j.st_sh.rx_bytes, j.st_sh.retransmits, j.st_sh.windows,
         j.st_sh.occupancy_peak, j.st_sh.flushes)
    assert p.pol.events == j.pol.events
    assert shard_rows(p.svc.per_shard_report(p.st_sh)) == \
        shard_rows(j.svc.per_shard_report(j.st_sh))
    for a, b in zip(p.st_sh.shard_states, j.st_sh.shard_states):
        np.testing.assert_array_equal(a.index_words.numpy().view(np.uint32),
                                      b.index_words)
    if exact:
        np.testing.assert_array_equal(out_sh.numpy(), jout)
    else:
        np.testing.assert_allclose(out_sh.numpy(), jout, rtol=1e-5, atol=1e-6)
    return p


@pytest.mark.parametrize("wire", ["f32", "fxp32"])
@pytest.mark.parametrize("n_shards,batch_size", [(2, 3), (3, 1), (6, 2)])
def test_sharded_batched_fold_matches_sequential(J, wire, n_shards,
                                                 batch_size):
    cfg = CFG if wire == "f32" else CFG_FX
    cohort = (3, 7, 11, 20, 21)       # non-contiguous client ids
    r = np.random.default_rng(n_shards * 10 + batch_size)
    perm = list(r.permutation(list(cohort)))
    delays = {c: float(d) for c, d in
              zip(cohort, r.choice([0.0, 0.08, 0.17], size=len(cohort)))}
    trees = [dyadic_tree(100 + i) for i in range(len(cohort))]
    _check_pair(J, cfg, cohort, n_shards, batch_size, perm, delays, trees,
                exact=True)


def test_randomized_parity_sweep(J):
    """Seeded random cohorts, shard counts, microbatch sizes and arrival
    permutations, both wires: outputs and accounting bit-identical."""
    r = np.random.default_rng(2026)
    for trial in range(6):
        cfg = CFG if trial % 2 == 0 else CFG_FX
        n_clients = int(r.integers(2, 8))
        cohort = tuple(sorted(r.choice(64, size=n_clients,
                                       replace=False).tolist()))
        n_shards = int(r.integers(1, _plan(cfg).n_buckets + 1))
        batch_size = int(r.integers(1, n_clients + 2))
        perm = list(r.permutation(list(cohort)))
        delays = {c: float(r.choice([0.0, 0.06, 0.13])) for c in cohort}
        trees = [dyadic_tree(300 + 20 * trial + i) for i in range(n_clients)]
        _check_pair(J, cfg, cohort, n_shards, batch_size, perm, delays, trees,
                    exact=True)


def test_sharded_batched_fold_property(J):
    """The hypothesis property of the reference, at its 12 examples:
    Gaussian gradients, random cohorts, shard counts, microbatch sizes
    and arrival permutations, both wires."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=12, deadline=None, derandomize=True)
    @hyp.given(data=st.data(), wire=st.sampled_from(["f32", "fxp32"]),
               n_clients=st.integers(2, 7), batch_size=st.integers(1, 8),
               seed=st.integers(0, 2**31))
    def prop(data, wire, n_clients, batch_size, seed):
        cfg = CFG if wire == "f32" else CFG_FX
        r = np.random.default_rng(seed)
        cohort = tuple(sorted(r.choice(128, size=n_clients,
                                       replace=False).tolist()))
        n_shards = data.draw(st.integers(1, _plan(cfg).n_buckets))
        trees = [gauss_tree(seed + i) for i in range(n_clients)]
        delays = {c: float(r.choice([0.0, 0.07, 0.16])) for c in cohort}
        perm = list(r.permutation(list(cohort)))
        _check_pair(J, cfg, cohort, n_shards, batch_size, perm, delays, trees,
                    exact=False)
    prop()


def test_sharded_f32_fold_is_arrival_order_invariant(J):
    """Batched f32 folds reduce in canonical client-sorted order, so any
    arrival permutation and microbatch partition give the same f32 bits
    (non-dyadic gradients: the rounding is live), the reference's."""
    plan = _plan()
    cohort = tuple(range(5))
    contract = negotiate_contract(0, cohort, plan, CFG)
    clients = {c: ElasticClient(c, CFG, device=CPU) for c in cohort}
    r = np.random.default_rng(5)
    trees = [gauss_tree(int(s)) for s in r.integers(0, 2**31, size=5)]
    payloads = {c: clients[c].contribute(contract, trees[c]) for c in cohort}
    outs = []
    for (perm, bs) in [((0, 1, 2, 3, 4), 1), ((4, 2, 0, 3, 1), 2),
                       ((1, 3, 0, 4, 2), 5), ((2, 4, 1, 0, 3), 3)]:
        svc = ShardedFoldService(contract, CFG, n_shards=2, batch_size=bs,
                                 plan=plan, device=CPU)
        st = svc.init_state()
        for c in perm:
            svc.fold(st, payloads[c])
        outs.append(svc.finalize(st))
    for o in outs[1:]:
        assert torch.equal(outs[0], o)
    jc = J.el.negotiate_contract(0, cohort, J.plan(TEMPLATE, J.cfg), J.cfg)
    jsvc = J.el.ShardedFoldService(jc, J.cfg, n_shards=2, batch_size=2,
                                   plan=J.plan(TEMPLATE, J.cfg))
    jst = jsvc.init_state()
    for c in (4, 2, 0, 3, 1):
        jsvc.fold(jst, J.el.ElasticClient(c, J.cfg).contribute(jc, trees[c]))
    np.testing.assert_allclose(outs[0].numpy(), jsvc.finalize(jst),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# fxp32 batched-partial overflow: the dynamic-W gate, batched
# ----------------------------------------------------------------------

def _overflow_round(el, cfg, q_cell, batch_size, **kw):
    """A 9-client fxp32 round whose payload cells all hold ``q_cell``,
    folded as microbatches of ``batch_size`` (package ``el``)."""
    plan = el.plan(TEMPLATE, cfg)
    cohort = tuple(range(9))
    contract = el.negotiate_contract(0, cohort, plan, cfg)
    svc = el.ShardedFoldService(contract, cfg, n_shards=3,
                                batch_size=batch_size, plan=plan, **kw)
    st = svc.init_state()
    for c in cohort:
        svc.propose_exponents(st, c, el.full((contract.n_buckets,), 10, "i32"))
    sealed = svc.seal_exponents(st)
    sk = el.full((svc.n_blocks, cfg.rows, cfg.lanes), q_cell, "i32")
    wd = el.full((plan.padded // 32,), 0, "words")
    for c in cohort:
        svc.fold(st, el.Payload(client=c, contract_id=contract.contract_id,
                                sketch=sk, index_words=wd, exponents=sealed))
    return svc, st


def _tensor_full(shape, v, kind):
    return torch.full(shape, v, dtype=torch.int32)


def _numpy_full(shape, v, kind):
    return np.full(shape, v, np.uint32 if kind == "words" else np.int32)


def _seq_overflow(el, cfg, q_cell, **kw):
    plan = el.plan(TEMPLATE, cfg)
    contract = el.negotiate_contract(0, range(9), plan, cfg)
    seq = el.FoldEngine(contract, cfg, **kw)
    st = seq.init_state()
    for c in range(9):
        seq.propose_exponents(st, c, el.full((contract.n_buckets,), 10, "i32"))
    sealed = seq.seal_exponents(st)
    sk = el.full(seq.sketch_shape, q_cell, "i32")
    wd = el.full((seq.n_words,), 0, "words")
    for c in range(9):
        seq.fold(st, el.Payload(client=c, contract_id=contract.contract_id,
                                sketch=sk, index_words=wd, exponents=sealed))


def test_fxp32_batched_partial_overflow_matches_sequential_gate(J):
    """W grows 4 -> 9, restated for batched partials: nine stale-budget
    (M=28) worst-case payloads overflow int32, and the microbatched fold
    raises the switch's register-check OverflowError as the sequential
    walk does, in the reference's words; the renegotiated budget (M=26)
    folds clean."""
    w4, w9 = FixedPointWire(4), FixedPointWire(4).with_workers(9)
    assert (w4.mantissa_bits, w9.mantissa_bits) == (28, 26)
    q_stale, q_new = 2**28 - 2**4, 2**26 - 2**2
    assert 9 * q_stale > 2**31 - 1 and 9 * q_new <= 2**30
    with pytest.raises(OverflowError, match="32-bit switch register"):
        SwitchModel(ports=9, slots=4).check_batched_partial(
            9 * q_stale, 0, ports=9)
    SwitchModel(ports=9, slots=4).check_batched_partial(9 * q_new, 0)

    pel = port_el()
    pel.full, pel.Payload = _tensor_full, ClientPayload
    jel = jax_el(J)
    jel.full, jel.Payload = _numpy_full, J.el.ClientPayload
    texts = []
    for el, cfg, kw in [(pel, CFG_FX, {"device": CPU}), (jel, J.cfg_fx, {})]:
        with pytest.raises(OverflowError) as batched:
            _overflow_round(el, cfg, q_stale, batch_size=9, **kw)
        with pytest.raises(OverflowError) as seq:
            _seq_overflow(el, cfg, q_stale, **kw)
        texts.append((str(batched.value), str(seq.value)))
    assert texts[0] == texts[1]
    assert all("32-bit switch register" in t for t in texts[0])

    svc, st = _overflow_round(pel, CFG_FX, q_new, batch_size=9, device=CPU)
    assert st.contributions == 9
    assert int(st.shard_states[0].sketch[0, 0, 0]) == 9 * q_new


def test_batched_fold_accounting_rolls_up_through_switch_pools(J):
    pel = port_el()
    pel.full, pel.Payload = _tensor_full, ClientPayload
    jel = jax_el(J)
    jel.full, jel.Payload = _numpy_full, J.el.ClientPayload
    svc, st = _overflow_round(pel, CFG_FX, 2**20, batch_size=4, device=CPU)
    jsvc, jst = _overflow_round(jel, J.cfg_fx, 2**20, batch_size=4)
    out = svc.finalize(st)
    jout = jsvc.finalize(jst)
    assert tuple(out.shape) == (st.contract.n_buckets, st.contract.bucket_elems)
    assert st.windows > 0 and 0 < st.occupancy_peak <= svc.window_slots
    per_shard = svc.per_shard_report(st)
    assert len(per_shard) == 3
    assert sum(row["buckets"] for row in per_shard) == st.contract.n_buckets
    assert all(row["contributions"] == 9 for row in per_shard)
    assert sum(row["windows"] for row in per_shard) == st.windows
    assert shard_rows(per_shard) == shard_rows(jsvc.per_shard_report(jst))
    for a, b in zip(st.shard_states, jst.shard_states):
        np.testing.assert_array_equal(a.sketch.numpy(), b.sketch)
    np.testing.assert_array_equal(out.numpy(), jout)


# ----------------------------------------------------------------------
# Recover-pass cache: keyed by contract geometry
# ----------------------------------------------------------------------

def test_recover_cache_shared_across_same_geometry_rounds():
    plan = _plan()
    c0 = negotiate_contract(0, range(3), plan, CFG)
    c1 = negotiate_contract(1, range(3), plan, CFG)
    e0, e1 = FoldEngine(c0, CFG, device=CPU), FoldEngine(c1, CFG, device=CPU)
    assert e0._recover is e1._recover
    svc = ShardedFoldService(c0, CFG, n_shards=2, plan=plan, device=CPU)
    assert svc.engines[0]._recover is svc.engines[1]._recover
    assert svc.engines[0]._recover is not e0._recover


def test_recover_cache_distinct_across_renegotiated_geometry(J):
    plan_a = _plan()
    small = {"a": np.zeros((900,), np.float32)}
    plan_b = make_bucket_plan([small["a"]], CFG)
    assert plan_a.n_buckets != plan_b.n_buckets
    ca = negotiate_contract(0, range(2), plan_a, CFG)
    cb = negotiate_contract(1, range(2), plan_b, CFG)
    ea, eb = FoldEngine(ca, CFG, device=CPU), FoldEngine(cb, CFG, device=CPU)
    assert ea._recover is not eb._recover
    jeb = J.el.FoldEngine(J.el.negotiate_contract(
        1, range(2), J.plan(small, J.cfg), J.cfg), J.cfg)
    for contract, engine, tree in (
            (ca, ea, None), (cb, eb, {"a": np.ones((900,), np.float32)})):
        st = engine.init_state()
        jst = jeb.init_state() if tree is not None else None
        for w in range(2):
            g = tree if tree is not None else dyadic_tree(500 + w)
            p = ElasticClient(w, CFG, device=CPU).contribute(contract, g)
            engine.fold(st, p)
            assert engine.decode_payload(p).numel() == \
                contract.n_buckets * contract.bucket_elems
            if jst is not None:
                jeb.fold(jst, J.el.ElasticClient(w, J.cfg).contribute(
                    jeb.contract, g))
        out = engine.finalize(st)
        assert tuple(out.shape) == (contract.n_buckets, contract.bucket_elems)
        assert torch.isfinite(out).all()
        if jst is not None:
            np.testing.assert_array_equal(out.numpy(), jeb.finalize(jst))
    plan_fx = _plan(CFG_FX)
    f4 = FoldEngine(negotiate_contract(0, range(4), plan_fx, CFG_FX), CFG_FX,
                    device=CPU)
    f9 = FoldEngine(negotiate_contract(1, range(9), plan_fx, CFG_FX), CFG_FX,
                    device=CPU)
    assert f4._recover is not f9._recover      # mantissa differs
    assert f4._recover is not ea._recover      # wire differs
    assert _recover_fn(CFG, ca.n_buckets * ca.bucket_elems, "f32",
                       None) is ea._recover


# ----------------------------------------------------------------------
# Server integration: sharded rounds close out identically
# ----------------------------------------------------------------------

def _server_rounds(make, client, sim, to_np):
    srv = make()
    clients = [client(w) for w in range(4)]
    for w in range(4):
        srv.join(w)
    outs = []
    for rnd in range(2):
        contract = srv.open_round()
        for w in range(4):
            p = clients[w].contribute(contract, dyadic_tree(700 + 10 * rnd + w))
            srv.submit(p, arrival_s=sim.client_delay(rnd, w))
        out, rep = srv.close_round(now_s=1.5)
        outs.append((to_np(out), dataclasses.asdict(rep)))
    return outs


def test_sharded_server_matches_unsharded_server_with_deferrals(J):
    sim = FailureSimulator(straggle_at=((0, 2, 5.0),))
    pol = AdmissionPolicy(max_cohort=8, quorum=0.5, deadline_s=1.0)
    runs = [_server_rounds(
        lambda kw=kw: ElasticServer(TEMPLATE, CFG, policy=pol, device=CPU,
                                    **kw),
        lambda w: ElasticClient(w, CFG, device=CPU), sim, lambda t: t.numpy())
        for kw in ({}, {"n_shards": 2, "batch_size": 2})]
    jpol = J.el.AdmissionPolicy(max_cohort=8, quorum=0.5, deadline_s=1.0)
    runs.append(_server_rounds(
        lambda: J.el.ElasticServer(TEMPLATE, J.cfg, policy=jpol, n_shards=2,
                                   batch_size=2),
        lambda w: J.el.ElasticClient(w, J.cfg), sim, np.asarray))
    keys = ("folded", "deferred", "close_reason", "rx_bytes_total",
            "residual_carried_in")
    for (o_a, r_a), (o_b, r_b), (o_j, r_j) in zip(*runs):
        np.testing.assert_array_equal(o_a, o_b)
        np.testing.assert_array_equal(o_a, o_j)
        assert [r_a[k] for k in keys] == [r_b[k] for k in keys]
        assert r_b == r_j
    assert runs[0][0][1]["deferred"] == 1
    assert runs[0][1][1]["residual_carried_in"]


def test_sharded_service_validation_mirrors_sequential():
    plan = _plan()
    contract = negotiate_contract(0, (0, 1), plan, CFG)
    svc = ShardedFoldService(contract, CFG, n_shards=2, batch_size=2,
                             plan=plan, device=CPU)
    st = svc.init_state()
    p = ElasticClient(0, CFG, device=CPU).contribute(contract, dyadic_tree(1))
    svc.fold(st, p)
    with pytest.raises(FoldError, match="already contributed"):
        svc.fold(st, p)
    with pytest.raises(FoldError, match="not in this round's cohort"):
        svc.fold(st, ElasticClient(9, CFG, device=CPU).contribute(
            contract, dyadic_tree(2)))
    with pytest.raises(StaleContractError, match="re-encode"):
        svc.fold(st, dataclasses.replace(p, contract_id="r9:bogus"))
    with pytest.raises(FoldError, match="nothing folded"):
        svc.finalize(svc.init_state())
    with pytest.raises(ValueError, match="batch_size"):
        ShardedFoldService(contract, CFG, n_shards=2, batch_size=0,
                           device=CPU)
