"""Blockwise attention (``layers.flash_attention``) against the JAX
reference's ``repro.models.layers.flash_attention`` on the CPU, and the
plain encode's fixed summation order (``core.sketch.scatter_rows``).

The same numpy q, k, v (and output cotangent) go through both, as f32
or as bf16 operands. Cases: causal and not; 1, 2 and 4 query heads a KV
head; query lengths above ``q_block`` and no multiple of it; key lengths
above the 1,024-key block and no multiple of it; ``Sq != Skv``;
``q_offset > 0``.

Tolerances, set from the dtype: f32 outputs at ``tests/test_torch_encdec.py``'s
``TOL`` (rtol 1e-5, atol 1e-6) and f32 gradients (``jax.vjp`` of the
reference) at rtol 1e-5 with atol 1e-6 of the leaf's largest entry (the
two sum a row's ``p`` and the gradients' block products in other
orders). bf16 outputs within atol 2^-8 of the largest entry (one bf16
ulp: both round the same f32 value, which differs in its last bits);
bf16 gradients within atol 2^-6 of the leaf's largest entry (the
reference adds each query block's dK and dV into the bf16 cotangent, up
to 3 roundings here; the port sums in f32 and rounds once).

What autograd keeps: a ``saved_tensors_hooks`` count of the bytes saved
for the backward stays below a tenth of the ``B·H·Sq·Skv·4`` bytes of
one f32 score tensor. Skipping the causal key blocks above the diagonal
is bit for bit the same as computing them. The card's ``flash_attention``
is held to the CPU's in ``tests/test_torch_plain_cuda.py`` (no JAX
there).

The plain encode's scatter, and its gathers-and-adds form that runs off
the CPU, equal ``index_add_`` on the CPU (the order the hand encode sums
in) bit for bit, on Gaussian contributions with
signed zeros and integer degrees, at the main, lossless, exchange and
elastic geometries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import layers as JL
from repro_torch.core import sketch as S
from repro_torch.core.config import CompressionConfig
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_OUT, BF16_GRAD = 2.0 ** -8, 2.0 ** -6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (name, B, Sq, Skv, H, KV, causal, q_block, q_offset)
CASES = [
    ("causal_rep2", 2, 100, 100, 4, 2, True, 64, 0),
    ("noncausal_rep1", 2, 100, 100, 4, 4, False, 64, 0),
    ("causal_rep4_long", 1, 1100, 1100, 4, 1, True, 512, 0),
    ("cross_long_keys", 2, 130, 1100, 4, 2, False, 64, 0),
    ("causal_offset", 1, 70, 1100, 4, 4, True, 64, 1030),
    ("causal_short_q", 2, 40, 90, 4, 1, True, 64, 50),
]
HD = 16


def _inputs(b, sq, skv, h, kv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, HD)).astype(np.float32),
            rng.standard_normal((b, skv, kv, HD)).astype(np.float32),
            rng.standard_normal((b, skv, kv, HD)).astype(np.float32),
            rng.standard_normal((b, sq, h, HD)).astype(np.float32))


def _port(q, k, v, do, dtype, causal, q_block, q_offset):
    t = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = L.flash_attention(*t, causal, q_block, q_offset=q_offset)
    grads = torch.autograd.grad(out, t, torch.tensor(do).to(dtype))
    return [x.detach().float().numpy() for x in (out,) + grads]


def _reference(q, k, v, do, dtype, causal, q_block, q_offset):
    f = jax.jit(lambda a, b, c: JL.flash_attention(
        a, b, c, causal=causal, q_block=q_block, q_offset=q_offset))
    j = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *j)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out,) + tuple(grads)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_matches_reference(case, dtype):
    _, b, sq, skv, h, kv, causal, qb, off = case
    q, k, v, do = _inputs(b, sq, skv, h, kv)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = _port(q, k, v, do, tdt, causal, qb, off)
    want = _reference(q, k, v, do, jdt, causal, qb, off)
    assert got[0].shape == (b, sq, h, HD)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        scale = np.abs(w).max()
        if dtype == "f32" and name == "out":
            np.testing.assert_allclose(g, w, **TOL)
        elif dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=name)
        else:
            tol = BF16_OUT if name == "out" else BF16_GRAD
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                       err_msg=name)


@pytest.mark.parametrize("case", [c for c in CASES if c[6]],
                         ids=[c[0] for c in CASES if c[6]])
def test_skipping_masked_key_blocks_is_bit_identical(case):
    _, b, sq, skv, h, kv, causal, qb, off = case
    q, k, v, do = _inputs(b, sq, skv, h, kv, seed=1)
    rep = h // kv
    runs = []
    for skip in (True, False):
        t = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
        pairs = L._block_pairs(sq, skv, causal, qb, L.KV_BLOCK, off, skip=skip)
        out = L._FlashAttention.apply(t[0], t[1].repeat_interleave(rep, dim=2),
                                      t[2].repeat_interleave(rep, dim=2),
                                      pairs, off)
        runs.append((out,) + torch.autograd.grad(out, t, torch.tensor(do)))
    for a, b_ in zip(*runs):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))


def test_skipped_blocks_are_the_ones_above_the_diagonal():
    pairs = L._block_pairs(4096, 4096, True, 512, 1024, 0)
    assert [len(row) for _, row in pairs] == [1, 1, 2, 2, 3, 3, 4, 4]
    assert [m for _, row in pairs for _, m in row] == [
        True, True, False, True, False, True, False, False, True,
        False, False, True, False, False, False, True, False, False, False,
        True]
    assert all(len(row) == 2 for _, row in
               L._block_pairs(1500, 1500, False, 512, 1024, 0))


def test_saved_for_backward_is_linear_in_the_sequence():
    b, s, h, kv = 1, 1100, 4, 2
    q, k, v, _ = _inputs(b, s, s, h, kv)
    t = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    saved = []

    def pack(x):
        saved.append(x.numel() * x.element_size())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = L.flash_attention(*t, True, 512)
    scores = b * h * s * s * 4
    assert 0 < sum(saved) < scores / 10, (sum(saved), scores)
    out.sum().backward()
    assert all(x.grad is not None for x in t)


def test_attention_train_runs_blockwise():
    """``attention_train`` reaches ``flash_attention`` with the config's
    ``q_block`` (the one-pass ``attention`` is gone)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("granite-3-2b").smoke
    assert not hasattr(L, "attention")
    calls = []
    orig = L.flash_attention

    def spy(q, k, v, causal, q_block, *a, **kw):
        calls.append((q.shape[1], k.shape[1], causal, q_block))
        return orig(q, k, v, causal, q_block, *a, **kw)

    L.flash_attention = spy
    try:
        gen = torch.Generator().manual_seed(0)
        p = {n: w[0] for n, w in L.init_attention(gen, cfg, (1,)).items()}
        x = torch.randn(2, 100, cfg.d_model, generator=gen)
        L.attention_train(x, p, cfg)
    finally:
        L.flash_attention = orig
    assert calls == [(100, 100, True, cfg.q_block)]


GEOMETRIES = [CompressionConfig(ratio=0.1, topk_ratio=0.04),
              CompressionConfig(ratio=2.0, rows=60),
              CompressionConfig(ratio=2.5, rows=6),
              CompressionConfig(ratio=1.0, lanes=128, rows=6)]


@pytest.mark.parametrize("cfg", GEOMETRIES,
                         ids=["main", "lossless", "exchange", "elastic"])
def test_scatter_rows_equals_index_add_bit_for_bit(cfg):
    cpu = torch.device("cpu")
    rows_flat, _ = S.device_tables(cfg, cpu)
    lists = S.row_lists(cfg, cpu)
    gen = torch.Generator().manual_seed(cfg.group)
    nb = 16
    c = torch.randn((nb, cfg.group, 3, cfg.lanes), generator=gen)
    c[c.abs() < 0.3] = 0.0
    c[(c.abs() < 0.6) & (c != 0)] = -0.0
    ints = (c != 0).to(torch.int32)
    for contrib in (c, ints):
        want = torch.zeros((nb, cfg.rows, cfg.lanes), dtype=contrib.dtype)
        want.index_add_(1, rows_flat, contrib.reshape(nb, -1, cfg.lanes))
        for fn in (S.scatter_rows, S.scatter_rows_ordered):
            got = fn(contrib, lists)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # every source once, in ascending order a row, the padding at the end
    table = S.plan_row_lists(cfg)
    real = table[table >= 0]
    assert sorted(real.tolist()) == list(range(cfg.group * 3))
    for row in table:
        r = row[row >= 0]
        assert (np.diff(r) > 0).all() and (row[len(r):] == -1).all()
