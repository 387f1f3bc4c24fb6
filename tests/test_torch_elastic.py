"""PyTorch port vs the JAX reference: the elastic aggregation service
(membership, fold, client, server) and failure injection.

Each case mirrors one of ``tests/test_elastic.py`` (and of
``tests/test_data_ft.py`` for ``ft/failures.py``): the same numpy
gradients go through the JAX objects and through their port (on the
CPU), and the results are compared:

- contract ids, reports, windows, occupancy and RX bytes exactly;
- int32 sketches, bitmap words and exponents exactly;
- f32 streams bit for bit on dyadic gradients (every sum is exact in any
  order); on Gaussian ones within ``rtol=1e-5, atol=1e-6`` (the two
  frameworks sum a sketch cell's contributions in their own orders, and
  an fxp32 cell can move one step of ``2^(e - M)``).

The JAX side runs as its own tests run it on the CPU; its imports stay
inside the tests.
"""
import dataclasses
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bucketing import make_bucket_plan
from repro_torch.core.compressor import CompressedLeaf, HomomorphicCompressor
from repro_torch.core.config import CompressionConfig
from repro_torch.elastic import (AdmissionPolicy, ElasticClient, ElasticServer,
                                 FoldEngine, FoldError, Membership,
                                 QuorumNotReached, RoundContract,
                                 StaleContractError, negotiate_contract)
from repro_torch.ft.failures import (FailureSimulator, InjectedFailure,
                                     StragglerMonitor, elastic_data_parallel,
                                     elastic_mesh)
from repro_torch.net.fixedpoint import FixedPointWire
from repro_torch.net.switch import SwitchModel

CFG = CompressionConfig(ratio=1.0, lanes=128, rows=6, rounds=10,
                        chunk_blocks=8, topk_ratio=0.1, topk_exact=True,
                        error_feedback=True, bucket_bytes=2 * 768 * 4)
CFG_FX = dataclasses.replace(CFG, wire_dtype="fxp32")
SHAPES = {"a": (2000,), "b": (50, 20)}
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
    """The reference's elastic service and failures."""
    from repro.core.config import CompressionConfig as JConfig
    from repro.core.bucketing import make_bucket_plan as j_plan
    from repro import elastic
    from repro.ft import failures
    cfg = JConfig(**dataclasses.asdict(CFG))
    return types.SimpleNamespace(
        el=elastic, ft=failures, plan=j_plan, cfg=cfg,
        cfg_fx=dataclasses.replace(cfg, wire_dtype="fxp32"))


def dyadic_tree(seed):
    """sign * 2^e values: every summation order is exact (the
    reference's construction)."""
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


def gauss_tree(r, scale=1.0):
    return {k: (r.normal(0, 1, sh) * scale).astype(np.float32)
            for k, sh in SHAPES.items()}


def _plan(cfg=CFG):
    return make_bucket_plan([TEMPLATE[k] for k in sorted(TEMPLATE)], cfg)


def words_u32(t):
    return t.numpy().view(np.uint32)


def assert_contract_equal(p, j):
    assert p.contract_id == j.contract_id
    assert (p.round_id, p.cohort, p.n_buckets, p.bucket_elems, p.total_elems,
            p.wire_dtype, p.mantissa_bits) == \
        (j.round_id, j.cohort, j.n_buckets, j.bucket_elems, j.total_elems,
         j.wire_dtype, j.mantissa_bits)


def assert_report_equal(p, j):
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


# ----------------------------------------------------------------------
# RoundContract: the versioned handshake
# ----------------------------------------------------------------------

def test_contract_negotiation_and_validation(J):
    plan, jplan = _plan(CFG_FX), J.plan(TEMPLATE, J.cfg_fx)
    assert (plan.n_buckets, plan.bucket_elems, plan.total) == \
        (jplan.n_buckets, jplan.bucket_elems, jplan.total)
    c4 = negotiate_contract(0, [3, 1, 0, 2], plan, CFG_FX)
    assert_contract_equal(c4, J.el.negotiate_contract(0, [3, 1, 0, 2], jplan,
                                                      J.cfg_fx))
    assert c4.cohort == (0, 1, 2, 3) and c4.workers == 4
    assert c4.mantissa_bits == 28 and c4.wire.mantissa_bits == 28
    c5 = negotiate_contract(1, range(5), plan, CFG_FX)
    assert_contract_equal(c5, J.el.negotiate_contract(1, range(5), jplan,
                                                      J.cfg_fx))
    assert c5.mantissa_bits == 27 and c4.contract_id != c5.contract_id
    with pytest.raises(ValueError, match="renegotiate"):
        RoundContract(round_id=1, cohort=(0, 1, 2, 3, 4),
                      n_buckets=plan.n_buckets,
                      bucket_elems=plan.bucket_elems,
                      total_elems=plan.total, wire_dtype="fxp32",
                      mantissa_bits=28)
    with pytest.raises(ValueError, match="sorted"):
        RoundContract(round_id=0, cohort=(2, 1), n_buckets=1,
                      bucket_elems=1536, total_elems=1536,
                      wire_dtype="f32", mantissa_bits=None)
    with pytest.raises(ValueError, match="no mantissa"):
        RoundContract(round_id=0, cohort=(0,), n_buckets=1,
                      bucket_elems=1536, total_elems=1536,
                      wire_dtype="f32", mantissa_bits=30)
    f32 = negotiate_contract(0, [0, 1], _plan(), CFG)
    assert_contract_equal(f32, J.el.negotiate_contract(
        0, [0, 1], J.plan(TEMPLATE, J.cfg), J.cfg))
    assert f32.mantissa_bits is None
    with pytest.raises(ValueError):
        f32.wire


def test_membership_admission_queue_and_leave(J):
    ms = [Membership(max_cohort=2), J.el.Membership(max_cohort=2)]
    outs = []
    for m in ms:
        seen = [m.join(0), m.join(1), m.join(2), m.roster, m.queued]
        with pytest.raises(ValueError):
            m.join(1)
        m.leave(0)
        seen += [m.admit_queued(), m.roster]
        with pytest.raises(KeyError):
            m.leave(0)
        outs.append(seen)
    assert outs[0] == outs[1]
    assert outs[0] == ["admitted", "admitted", "queued", (0, 1), (2,), (2,),
                       (1, 2)]
    # 2 members on a pool of 8 devices: data 2 (the reference's sizing)
    assert ms[0].local_mesh(devices=8).shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="model_parallel"):
        ms[0].local_mesh(model_parallel=2, devices=1)


# ----------------------------------------------------------------------
# Fold engine: arrival-order invariance, O(1) state, windows
# ----------------------------------------------------------------------

def _f32_payloads(contract, n, seed0=40):
    clients = [ElasticClient(w, CFG, device=CPU) for w in range(n)]
    return clients, [clients[w].contribute(contract, dyadic_tree(seed0 + w))
                     for w in range(n)]


def _j_f32_payloads(J, contract, n, seed0=40):
    clients = [J.el.ElasticClient(w, J.cfg) for w in range(n)]
    return clients, [clients[w].contribute(contract, dyadic_tree(seed0 + w))
                     for w in range(n)]


def test_fold_is_arrival_order_invariant_and_loss_free(J):
    contract = negotiate_contract(0, range(3), _plan(), CFG)
    engine = FoldEngine(contract, CFG, device=CPU)
    _, payloads = _f32_payloads(contract, 3)
    outs = []
    for perm in ([0, 1, 2], [2, 0, 1], [1, 2, 0]):
        st = engine.init_state()
        for w in perm:
            engine.fold(st, payloads[w])
        outs.append(engine.finalize(st))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    want = sum(engine.decode_payload(p) for p in payloads)
    assert torch.equal(outs[0], want)
    # the reference on the same gradients: payloads and stream bit for bit
    jc = J.el.negotiate_contract(0, range(3), J.plan(TEMPLATE, J.cfg), J.cfg)
    jeng = J.el.FoldEngine(jc, J.cfg)
    _, jpay = _j_f32_payloads(J, jc, 3)
    jst = jeng.init_state()
    for p in jpay:
        jeng.fold(jst, p)
    for p, q in zip(payloads, jpay):
        assert p.contract_id == q.contract_id and p.nbytes == q.nbytes
        np.testing.assert_array_equal(p.sketch.numpy(), np.asarray(q.sketch))
        np.testing.assert_array_equal(words_u32(p.index_words),
                                      np.asarray(q.index_words))
    np.testing.assert_array_equal(outs[0].numpy(), jeng.finalize(jst))


def test_fold_state_is_payload_shaped_and_windowed(J):
    plan = _plan()
    contract = negotiate_contract(0, range(3), plan, CFG)
    engine = FoldEngine(contract, CFG, window_slots=1, device=CPU)
    st = engine.init_state()
    _, payloads = _f32_payloads(contract, 3)
    base = (st.sketch.shape, st.index_words.shape)
    for p in payloads:
        engine.fold(st, p)
    assert (st.sketch.shape, st.index_words.shape) == base
    assert st.windows == 3 * plan.n_buckets
    assert st.occupancy_peak == 1 and st.contributions == 3
    assert set(st.rx_bytes) == {0, 1, 2}
    assert all(v == payloads[0].nbytes for v in st.rx_bytes.values())
    jc = J.el.negotiate_contract(0, range(3), J.plan(TEMPLATE, J.cfg), J.cfg)
    jeng = J.el.FoldEngine(jc, J.cfg, window_slots=1)
    jst = jeng.init_state()
    for p in _j_f32_payloads(J, jc, 3)[1]:
        jeng.fold(jst, p)
    assert (st.windows, st.occupancy_peak, st.contributions, st.rx_bytes,
            st.clients) == (jst.windows, jst.occupancy_peak,
                            jst.contributions, jst.rx_bytes, jst.clients)
    assert tuple(st.sketch.shape) == jst.sketch.shape
    np.testing.assert_array_equal(st.sketch.numpy(), jst.sketch)
    np.testing.assert_array_equal(words_u32(st.index_words), jst.index_words)


def _fold_errors(engine, st, payloads, err):
    """The messages of the reference test's rejection sequence."""
    replace = dataclasses.replace
    msgs = []
    engine.fold(st, payloads[0])
    for bad in (payloads[0], replace(payloads[1], client=7)):
        with pytest.raises(err) as e:
            engine.fold(st, bad)
        msgs.append(str(e.value))
    engine.fold(st, payloads[1])
    with pytest.raises(err) as e:
        engine.fold(st, replace(payloads[0], client=0))
    msgs.append(str(e.value))
    st2 = engine.init_state()
    st2.contributions = 2
    with pytest.raises(err) as e:
        engine.fold(st2, payloads[0])
    msgs.append(str(e.value))
    return msgs


def test_fold_rejects_duplicates_unknown_and_oversubscription(J):
    contract = negotiate_contract(0, range(2), _plan(), CFG)
    engine = FoldEngine(contract, CFG, device=CPU)
    got = _fold_errors(engine, engine.init_state(),
                       _f32_payloads(contract, 2)[1], FoldError)
    jc = J.el.negotiate_contract(0, range(2), J.plan(TEMPLATE, J.cfg), J.cfg)
    jeng = J.el.FoldEngine(jc, J.cfg)
    want = _fold_errors(jeng, jeng.init_state(), _j_f32_payloads(J, jc, 2)[1],
                        J.el.FoldError)
    assert got == want
    assert [m.split(" ")[-1] for m in got] == \
        ["round", "cohort", "round", "hold)"]
    # a wrong geometry is refused, as in the reference
    p = _f32_payloads(contract, 1)[1][0]
    with pytest.raises(FoldError, match="sketch must be"):
        engine.fold(engine.init_state(),
                    dataclasses.replace(p, sketch=p.sketch[:-1]))
    with pytest.raises(FoldError, match="index_words must be"):
        engine.fold(engine.init_state(), dataclasses.replace(
            p, index_words=p.index_words.to(torch.int64)))


# ----------------------------------------------------------------------
# fxp32: two-phase rounds == the documented codec roundtrip
# ----------------------------------------------------------------------

def test_fxp32_fold_matches_roundtrip_reference_bitwise(J):
    plan = _plan(CFG_FX)
    W = 5
    contract = negotiate_contract(0, range(W), plan, CFG_FX)
    engine = FoldEngine(contract, CFG_FX, device=CPU)
    st = engine.init_state()
    clients = [ElasticClient(w, CFG_FX, device=CPU) for w in range(W)]
    r = np.random.default_rng(11)
    trees = [gauss_tree(r) for _ in range(W)]
    for w in range(W):
        p = clients[w].propose(contract, trees[w])
        engine.propose_exponents(st, p.client, p.exponents, p.contract_id)
    shared = engine.seal_exponents(st)
    payloads = [clients[w].payload(contract, shared) for w in range(W)]
    order = np.random.default_rng(2).permutation(W)
    for w in order:
        engine.fold(st, payloads[w])
    got = engine.finalize(st)

    # the port's own documented roundtrip, bit for bit
    wire = FixedPointWire(workers=W)
    sks = [c._cache["sketch"] for c in clients]
    dec = wire.roundtrip_reference([s.reshape(plan.n_buckets, -1) for s in sks])
    words = clients[0]._cache["index_words"].clone()
    for c in clients[1:]:
        words |= c._cache["index_words"]
    rec = HomomorphicCompressor(CFG_FX).recover(
        CompressedLeaf(sketch=dec.reshape(sks[0].shape), index_words=words),
        plan.padded)
    assert torch.equal(got, rec.reshape(plan.n_buckets, plan.bucket_elems))

    # the reference's fold on the same gradients
    jc = J.el.negotiate_contract(0, range(W), J.plan(TEMPLATE, J.cfg_fx),
                                 J.cfg_fx)
    jeng = J.el.FoldEngine(jc, J.cfg_fx)
    jst = jeng.init_state()
    jcl = [J.el.ElasticClient(w, J.cfg_fx) for w in range(W)]
    for w in range(W):
        p = jcl[w].propose(jc, trees[w])
        jeng.propose_exponents(jst, p.client, p.exponents, p.contract_id)
    jshared = jeng.seal_exponents(jst)
    np.testing.assert_array_equal(shared.numpy(), jshared)
    jpay = [jcl[w].payload(jc, jshared) for w in range(W)]
    for w in order:
        jeng.fold(jst, jpay[w])
    np.testing.assert_array_equal(words_u32(st.index_words), jst.index_words)
    # an int32 cell may move one step where the frameworks' f32 sketch
    # sums round apart
    assert np.abs(st.sketch.numpy().astype(np.int64)
                  - jst.sketch.astype(np.int64)).max() <= W
    np.testing.assert_allclose(got.numpy(), jeng.finalize(jst),
                               rtol=1e-5, atol=1e-6)


def test_fxp32_payload_against_wrong_exponents_is_rejected(J):
    contract = negotiate_contract(0, range(2), _plan(CFG_FX), CFG_FX)
    engine = FoldEngine(contract, CFG_FX, device=CPU)
    st = engine.init_state()
    clients = [ElasticClient(w, CFG_FX, device=CPU) for w in range(2)]
    jc = J.el.negotiate_contract(0, range(2), J.plan(TEMPLATE, J.cfg_fx),
                                 J.cfg_fx)
    jcl = [J.el.ElasticClient(w, J.cfg_fx) for w in range(2)]
    for w in range(2):
        p = clients[w].propose(contract, dyadic_tree(60 + w))
        q = jcl[w].propose(jc, dyadic_tree(60 + w))
        np.testing.assert_array_equal(p.exponents.numpy(), q.exponents)
        engine.propose_exponents(st, p.client, p.exponents)
    shared = engine.seal_exponents(st)
    good = clients[0].payload(contract, shared)
    bad = dataclasses.replace(good, exponents=good.exponents + 1)
    with pytest.raises(StaleContractError, match="sealed"):
        engine.fold(st, bad)
    st2 = engine.init_state()
    with pytest.raises(StaleContractError, match="sealed"):
        engine.fold(st2, good)
    engine.fold(st, good)
    # the quantized payload is the reference's, integer for integer
    jgood = jcl[0].payload(jc, shared.numpy())
    np.testing.assert_array_equal(good.sketch.numpy(), np.asarray(jgood.sketch))
    assert good.nbytes == jgood.nbytes


# ----------------------------------------------------------------------
# Dynamic-W gate: renegotiation, stale rejection, overflow freedom
# ----------------------------------------------------------------------

def _dynamic_w(server, client_cls, cfg, trees):
    srv = server(TEMPLATE, cfg)
    for w in range(4):
        srv.join(w)
    clients = {w: client_cls(w) for w in range(4)}
    c0 = srv.open_round()
    for w in range(4):
        srv.submit_exponents(clients[w].propose(c0, trees[w]))
    shared0 = srv.seal_exponents()
    late = clients[0].payload(c0, shared0)
    for w in range(1, 4):
        srv.submit(clients[w].payload(c0, shared0))
    with pytest.raises(QuorumNotReached if server is ElasticServer
                       else Exception):
        srv.close_round()
    out0, rep0 = srv.close_round(now_s=2.0)
    srv.join(4)
    clients[4] = client_cls(4)
    c1 = srv.open_round()
    with pytest.raises(Exception, match="re-encode"):
        srv.submit(late)
    srv.submit_exponents(clients[0].reencode(c1))
    for w in range(1, 5):
        srv.submit_exponents(clients[w].propose(c1, trees[4 + w]))
    shared1 = srv.seal_exponents()
    with pytest.raises(Exception, match="reencode"):
        clients[0].payload(c0, shared1)
    status = [srv.submit(clients[w].payload(c1, shared1)) for w in range(5)]
    out1, rep1 = srv.close_round()
    return (c0, c1), (out0, out1), (rep0, rep1), status


def test_dynamic_w_renegotiates_and_rejects_stale_payloads(J):
    trees = [dyadic_tree(80 + w) for w in range(9)]
    got = _dynamic_w(
        lambda t, c: ElasticServer(t, c, policy=AdmissionPolicy(max_cohort=16),
                                   device=CPU),
        lambda w: ElasticClient(w, CFG_FX, device=CPU), CFG_FX, trees)
    want = _dynamic_w(
        lambda t, c: J.el.ElasticServer(
            t, c, policy=J.el.AdmissionPolicy(max_cohort=16)),
        lambda w: J.el.ElasticClient(w, J.cfg_fx), J.cfg_fx, trees)
    (c0, c1), outs, reps, status = got
    assert (c0.workers, c0.mantissa_bits, c1.workers, c1.mantissa_bits) == \
        (4, 28, 5, 27)
    assert status == ["folded"] * 5
    assert reps[1].close_reason == "complete" and reps[1].folded == 5
    assert reps[1].rejected_stale == 1
    for p, j in zip(got[0], want[0]):
        assert_contract_equal(p, j)
    for p, j in zip(reps, want[2]):
        assert_report_equal(p, j)
    for p, j in zip(outs, want[1]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert status == want[3]


def test_new_cohort_budget_never_overflows_int32_stale_budget_would(J):
    """W grows 4 -> 9: the renegotiated budget (M=26) keeps a 9-way
    worst-case sum inside int32; the stale budget (M=28) would not, and
    the switch's running-register check says so in the reference's
    words."""
    w4, w9 = FixedPointWire(4), FixedPointWire(4).with_workers(9)
    assert (w4.mantissa_bits, w9.mantissa_bits) == (28, 26)
    y = np.nextafter(np.float32(1024.0), np.float32(0.0))
    buckets = torch.full((1, 128), float(y), dtype=torch.float32)
    e = w4.bucket_exponents(buckets)
    q_stale = int(w4.encode(buckets, e)[0, 0])
    q_new = int(w9.encode(buckets, e)[0, 0])
    assert q_stale == 2**28 - 2**4
    assert 9 * q_stale > 2**31 - 1 and 9 * q_new <= 2**30
    bm = np.zeros((9, 1, 4), np.uint32)
    with pytest.raises(OverflowError, match="32-bit switch register"):
        SwitchModel(ports=9, slots=4).aggregate(
            np.full((9, 1, 128), q_stale, np.int32), bm)
    out, _ = SwitchModel(ports=9, slots=4).aggregate(
        np.full((9, 1, 128), q_new, np.int32), bm)
    assert int(out[0, 0]) == 9 * q_new

    # through the engine: a full-attendance 9-client fold of
    # max-magnitude payloads raises nothing and equals the reference's
    r = np.random.default_rng(3)
    trees = [gauss_tree(r, 1e30) for _ in range(9)]
    contract = negotiate_contract(0, range(9), _plan(CFG_FX), CFG_FX)
    engine = FoldEngine(contract, CFG_FX, device=CPU)
    st = engine.init_state()
    clients = [ElasticClient(w, CFG_FX, device=CPU) for w in range(9)]
    for w in range(9):
        p = clients[w].propose(contract, trees[w])
        engine.propose_exponents(st, p.client, p.exponents)
    shared = engine.seal_exponents(st)
    for w in range(9):
        engine.fold(st, clients[w].payload(contract, shared))
    out = engine.finalize(st)
    assert torch.isfinite(out).all()
    jc = J.el.negotiate_contract(0, range(9), J.plan(TEMPLATE, J.cfg_fx),
                                 J.cfg_fx)
    jeng = J.el.FoldEngine(jc, J.cfg_fx)
    jst = jeng.init_state()
    jcl = [J.el.ElasticClient(w, J.cfg_fx) for w in range(9)]
    for w in range(9):
        p = jcl[w].propose(jc, trees[w])
        jeng.propose_exponents(jst, p.client, p.exponents)
    jshared = jeng.seal_exponents(jst)
    np.testing.assert_array_equal(shared.numpy(), jshared)
    for w in range(9):
        jeng.fold(jst, jcl[w].payload(jc, jshared))
    assert (st.windows, st.occupancy_peak) == (jst.windows, jst.occupancy_peak)
    np.testing.assert_allclose(out.numpy(), jeng.finalize(jst), rtol=1e-5)


# ----------------------------------------------------------------------
# Straggler gate: quorum/deadline close, deferred -> next-round residual
# ----------------------------------------------------------------------

def _straggler_rounds(server, client_cls, ft, to_np):
    sim = ft.FailureSimulator(straggle_s=((2, 0.12),),
                              straggle_at=((0, 3, 5.0),))
    monitor = ft.StragglerMonitor(warmup=2)
    retrans = ft.SwitchRetransmitPolicy(timeout_s=0.05, max_retries=3)
    srv = server(monitor, retrans)
    for w in range(4):
        srv.join(w)
    clients = [client_cls(w) for w in range(4)]
    total = np.zeros((srv.plan.n_buckets, srv.plan.bucket_elems), np.float32)
    outs, reps, statuses = [], [], []
    for rnd in range(2):
        contract = srv.open_round()
        engine = srv._engine
        st = {}
        for w in range(4):
            p = clients[w].contribute(contract,
                                      dyadic_tree(200 + 10 * rnd + w))
            total += to_np(engine.decode_payload(p))
            st[w] = srv.submit(p, arrival_s=0.01 * (w + 1)
                               + sim.client_delay(rnd, w))
        statuses.append(st)
        if rnd == 0:
            out, rep = srv.close_round(now_s=0.5)
            assert np.any(to_np(srv.pending_residual) != 0)
        else:
            out, rep = srv.close_round()
        outs.append(to_np(out))
        reps.append(rep)
    residual = to_np(srv.pending_residual)
    return (outs, reps, statuses, total, residual, list(retrans.events),
            list(monitor.events))


def test_straggler_rounds_close_and_defer_loss_free(J):
    from repro_torch import ft
    got = _straggler_rounds(
        lambda mon, ret: ElasticServer(
            TEMPLATE, CFG, policy=AdmissionPolicy(max_cohort=8, quorum=0.5,
                                                  deadline_s=1.0),
            retransmit=ret, monitor=mon, device=CPU),
        lambda w: ElasticClient(w, CFG, device=CPU), ft,
        lambda t: t.numpy())
    want = _straggler_rounds(
        lambda mon, ret: J.el.ElasticServer(
            TEMPLATE, J.cfg, policy=J.el.AdmissionPolicy(
                max_cohort=8, quorum=0.5, deadline_s=1.0),
            retransmit=ret, monitor=mon),
        lambda w: J.el.ElasticClient(w, J.cfg), J.ft, np.asarray)
    outs, reps, statuses, total, residual, events, mon_events = got
    assert statuses[0][3] == "deferred" and statuses[0][2] == "folded"
    assert all(s == "folded" for s in statuses[1].values())
    assert reps[0].close_reason == "quorum"
    assert reps[0].folded == 3 and reps[0].deferred == 1
    assert reps[0].retransmits > 0 and events
    assert reps[1].close_reason == "complete" and reps[1].residual_carried_in
    # loss-free: folded + deferred == the sum of ALL payloads, bit for bit
    np.testing.assert_array_equal(outs[0] + outs[1] + residual, total)
    assert any(ev["dt"] >= 5.0 for ev in mon_events)
    # the reference on the same schedule: reports, events, streams
    for p, j in zip(reps, want[1]):
        assert_report_equal(p, j)
    assert statuses == want[2]
    assert events == want[5] and mon_events == want[6]
    for p, j in zip(outs + [residual, total], want[0] + [want[4], want[3]]):
        np.testing.assert_array_equal(p, j)


def test_quorum_not_reached_blocks_close():
    srv = ElasticServer(TEMPLATE, CFG,
                        policy=AdmissionPolicy(quorum=0.75, deadline_s=1.0),
                        device=CPU)
    for w in range(4):
        srv.join(w)
    contract = srv.open_round()
    c = ElasticClient(0, CFG, device=CPU)
    srv.submit(c.contribute(contract, dyadic_tree(1)))
    with pytest.raises(QuorumNotReached, match="1/4 folded, quorum is 3"):
        srv.close_round(now_s=5.0)


def test_server_round_lifecycle_guards():
    srv = ElasticServer(TEMPLATE, CFG, device=CPU)
    with pytest.raises(RuntimeError, match="no round is open"):
        srv.seal_exponents()
    srv.join(0)
    srv.open_round()
    with pytest.raises(RuntimeError, match="still open"):
        srv.open_round()
    for bad in (dict(max_cohort=0), dict(quorum=0.0), dict(deadline_s=0)):
        with pytest.raises(ValueError):
            AdmissionPolicy(**bad)


# ----------------------------------------------------------------------
# ft/failures.py: injection, stragglers, elastic sizing
# ----------------------------------------------------------------------

def test_failure_simulator_fires_once_and_draws_as_reference(J):
    sim = FailureSimulator(fail_at_steps=(3,))
    sim.check(2)
    with pytest.raises(InjectedFailure):
        sim.check(3)
    sim.check(3)   # already fired -> replay passes

    def draws(s):
        out = []
        for step in range(200):
            try:
                s.check(step)
                out.append(None)
            except Exception as e:   # the two packages' InjectedFailure
                out.append((e.step, e.node, str(e)))
        return out
    got = draws(FailureSimulator(p_fail=0.1, n_nodes=5, seed=7))
    assert got == draws(J.ft.FailureSimulator(p_fail=0.1, n_nodes=5, seed=7))
    assert 0 < sum(x is not None for x in got) < 200


def test_straggler_monitor_flags_outlier(J):
    mons = [StragglerMonitor(warmup=2), J.ft.StragglerMonitor(warmup=2)]
    seen = []
    for mon in mons:
        flags = [mon.observe(s, 0.1) for s in range(5)]
        flags += [mon.observe(5, 1.0), mon.observe(6, 0.11)]
        seen.append((flags, mon.events))
    assert seen[0] == seen[1]
    assert seen[0][0] == [False] * 5 + [True, False]
    assert len(seen[0][1]) == 1


def test_elastic_mesh_waits_for_the_mesh_port():
    # the mesh port has landed: elastic_mesh gives the (data, model) shape
    assert elastic_mesh(available_devices=1, model_parallel=1).shape == \
        {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        elastic_mesh(available_devices=1, model_parallel=2)


@pytest.mark.parametrize("avail,mp,data", [
    (7, 1, 4), (6, 2, 2), (5, 4, 1), (12, 3, 4), (8, 2, 4), (3, 2, 1),
    (1, 1, 1)])
def test_elastic_data_parallel_sizing(J, avail, mp, data):
    assert elastic_data_parallel(avail, mp) == data
    assert J.ft.elastic_data_parallel(avail, mp) == data


def test_elastic_data_parallel_validation():
    with pytest.raises(ValueError, match="devices"):
        elastic_data_parallel(1, 2)
    with pytest.raises(ValueError, match="model_parallel"):
        elastic_data_parallel(4, 0)


def test_failure_simulator_client_delay(J):
    for cls in (FailureSimulator, J.ft.FailureSimulator):
        sim = cls(straggle_s=((2, 0.5),), straggle_at=((1, 3, 2.0),))
        assert [sim.client_delay(r, c) for r, c in
                [(0, 2), (7, 2), (0, 3), (1, 3), (2, 3), (1, 0)]] == \
            [0.5, 0.5, 0.0, 2.0, 0.0, 0.0]
        sim2 = cls(straggle_s=((0, 0.1),), straggle_at=((0, 0, 1.0),))
        assert sim2.client_delay(0, 0) == pytest.approx(1.1)


# ----------------------------------------------------------------------
# The launcher's --elastic rounds
# ----------------------------------------------------------------------

# the reference launcher's lines (python -m repro.launch.serve --arch
# granite-3-2b --smoke --elastic --straggle), less the times and |out|
LAUNCH_LINES = [
    "round 0: W=4 wire={w} folded=4 deferred=0 retransmits=0 close=complete",
    "round 1: W=5 wire={w5} folded=4 deferred=1 retransmits=0 close=deadline",
    "round 2: W=5 wire={w5} folded=5 deferred=0 retransmits=0 close=complete",
]


@pytest.mark.parametrize("wire", ["f32", "fxp32"])
def test_serve_launcher_elastic_rounds(capsys, wire):
    """``python -m repro_torch.launch.serve --arch granite-3-2b --smoke
    --elastic --wire W --straggle --device cpu``, through its ``main``."""
    from repro_torch.launch.serve import main
    main(["--arch", "granite-3-2b", "--smoke", "--elastic", "--wire", wire,
          "--straggle", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    w, w5 = (wire, wire) if wire == "f32" else ("fxp32/M=28", "fxp32/M=27")
    assert len(lines) == 4
    for line, want in zip(lines, LAUNCH_LINES):
        assert re.fullmatch(re.escape(want.format(w=w, w5=w5))
                            + r" fold=\d+\.\dms \|out\|=\S+", line), line
    assert lines[3] == "elastic: 3 rounds, 14 payloads accounted (0 lost)"


def test_serve_launcher_runs_the_batch_mode(capsys):
    """Without ``--elastic`` the launcher serves: batch generation at the
    reference's defaults, and no elastic round."""
    from repro_torch.launch.serve import main
    out = main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                "--batch", "2", "--max-new", "4"])
    assert out.shape == (2, 4) and out.dtype == np.int32
    text = capsys.readouterr().out
    assert text.startswith("batch generate: (2, 4) tokens in ")
    assert "round " not in text and "elastic:" not in text


def test_serve_launcher_round_hooks_see_each_round():
    """``run_elastic``'s :class:`RoundHooks`: the caller's gradients are
    the ones folded, ``pending_state`` shows every folded payload before
    the close, and the close's stream and report reach ``after_close``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import RoundHooks, build_parser, run_elastic
    from repro_torch.models.params import unflatten_tree
    from repro_torch.models.registry import model_api

    class Hooks(RoundHooks):
        def __init__(self):
            self.seen = []

        def grads(self, rnd, client, shapes):
            if rnd != 0:
                return None
            return unflatten_tree([(p, torch.zeros(sh)) for p, sh in shapes])

        def before_close(self, rnd, server, contract, payloads):
            eng, st = server.pending_state()
            self.seen.append([rnd, st.contributions, sorted(payloads)])

        def after_close(self, rnd, server, stream, report):
            self.seen[-1] += [report.folded, stream]

    cfg = get_arch("granite-3-2b").smoke
    args = build_parser().parse_args(["--arch", "granite-3-2b", "--smoke",
                                      "--elastic", "--straggle",
                                      "--shards", "1", "--device", "cpu"])
    hooks = Hooks()
    srv, records = run_elastic(args, cfg, model_api(cfg).init(0, "cpu"),
                               hooks=hooks)
    assert [s[:4] for s in hooks.seen] == [[0, 4, [0, 1, 2, 3], 4],
                                           [1, 4, [0, 1, 2, 3, 4], 4],
                                           [2, 5, [0, 1, 2, 3, 4], 5]]
    # round 0 folds the hooks' zero gradients, the later rounds Gaussian
    assert not hooks.seen[0][4].any()
    assert all(bool(s[4].abs().max() > 0) for s in hooks.seen[1:])
    assert [r["folded"] for r in records] == [4, 4, 5]
    with pytest.raises(RuntimeError, match="no round is open"):
        srv.pending_state()
