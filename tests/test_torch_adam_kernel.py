"""The hand AdamW kernel (``kernels/adam_update.py``) and its dispatch.

On the CPU:

- the dispatch (``optimizer.fused_adamw``): AdamW on a CUDA device takes
  the kernel unless the policy is ``"never"``; the CPU and ``momentum``
  take the plain update, and ``apply_update`` on the CPU never reaches
  the kernel's wrapper;
- the wrapper's checks raise for the dtypes and strides the kernel does
  not take, and for tensors off the card, without building the kernel;
- the step scalars: ``_f32``'s fill kernel gives ``torch.tensor``'s
  bits, and ``step_scalars`` the bits of the plain path's expressions
  built from ``torch.tensor`` scalars.

On the card (``cuda``-marked, skipped without one; the module imports no
JAX): the kernel against ``clip_grads`` + ``opt_leaf_update`` bit for
bit, over parameter, aggregate and moment dtypes, ZeRO-1 slices on a
leading, middle and last dim at W 1, 2 and 4 with the moments whole and
narrowed or sliced, sizes that are no multiple of the vector width, step
0 and a step past warm-up, the clip engaged and not; and a whole
``apply_update`` on ``LocalWorkers(2)`` leaf by leaf against the plain
path (``use_pallas="never"``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.core.collectives import LocalWorkers
from repro_torch.kernels import adam_update as ak
from repro_torch.kernels.cuda_common import LAUNCHES
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod
from repro_torch.train.config import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import TrainState, apply_update, zero1_dims
from test_torch_ops import cuda_dev  # noqa: F401  (the card's fixture)

ADAM = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=20)
BF, F32 = torch.bfloat16, torch.float32


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(_bits(a), _bits(b))


# ----------------------------------------------------------------------
# On the CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind,device,policy,want", [
    ("adamw", "cuda", "auto", True), ("adamw", "cuda", "always", True),
    ("adamw", "cuda", "never", False), ("adamw", "cpu", "auto", False),
    ("adamw", "cpu", "always", ValueError), ("momentum", "cuda", "auto", False),
    ("momentum", "cuda", "never", False)])
def test_dispatch(kind, device, policy, want):
    """As the codec's dispatch reads the policy: ``"always"`` raises where
    the kernel cannot run (off the card)."""
    cfg = dataclasses.replace(ADAM, kind=kind)
    if want is ValueError:
        with pytest.raises(ValueError, match="always"):
            opt.fused_adamw(cfg, torch.device(device), policy)
        return
    assert opt.fused_adamw(cfg, torch.device(device), policy) is want


def _local_state(kind, dtype=F32, step=3):
    """A W=2 ZeRO-1 state of five leaves (one replicated), its grads and
    dims."""
    rng = np.random.default_rng(11)
    shapes = [(8, 6), (4, 10, 6), (6,), (3, 7), (2, 16)]
    tc = TrainConfig(workers=2, zero1=True,
                     optimizer=dataclasses.replace(ADAM, kind=kind))
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
              for s in shapes]
    grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
             for s in shapes]
    state = TrainState(params=type("Params", (), {"leaves": lambda self: leaves})(),
                       opt=opt.init_opt_state(leaves, tc.optimizer), residual=[],
                       step=step)
    return state, grads, zero1_dims(leaves, tc), tc


@pytest.mark.parametrize("kind", ["adamw", "momentum"])
def test_cpu_update_takes_the_plain_path(monkeypatch, kind):
    """On the CPU ``apply_update`` never reaches the kernel's wrapper,
    launches nothing, keeps its clip span and counts no plain slice (that
    counter is the card's)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU update reached the kernel")
    monkeypatch.setattr(step_mod, "adam_update_cuda", refuse)
    state, grads, dims, tc = _local_state(kind)
    before = LAUNCHES["adam_update"]
    obs.enable("cpu")
    obs.reset()
    try:
        apply_update(state, grads, dims, LocalWorkers(2), tc.optimizer,
                     use_pallas="auto")
        snap = obs.snapshot()
    finally:
        obs.disable()
        obs.reset()
    assert LAUNCHES["adam_update"] == before
    assert "optimizer/clip" in snap["spans"]
    assert "optimizer/plain_slices" not in snap["counters"]


def _slices(shape, d, w, dtype=F32, mdtype=F32):
    p = torch.zeros(shape, dtype=dtype)
    blk = shape[d] // w
    return ([p.narrow(d, i * blk, blk) for i in range(w)],
            [torch.zeros(shape, dtype=dtype).narrow(d, i * blk, blk) for i in range(w)],
            [torch.zeros(shape, dtype=mdtype).narrow(d, i * blk, blk) for i in range(w)],
            [torch.zeros(shape, dtype=mdtype).narrow(d, i * blk, blk) for i in range(w)])


@pytest.mark.parametrize("shape,d,w,want,tile", [
    ((64, 24), 0, 2, ak.Layout(1, 1, 32 * 24), False),
    ((3, 16, 40), 1, 2, ak.Layout(3, 8, 40), False),
    ((4, 70, 96), 2, 2, ak.Layout(280, 48, 1), True),
    ((37, 29), None, 1, ak.Layout(1, 1, 37 * 29), False)])
def test_layout(shape, d, w, want, tile):
    ps, gs, ms, vs = _slices(shape, 0 if d is None else d, w)
    geo, strides = ak.layout(ps, gs, ms, vs, d)
    assert geo == want and geo.tile is tile
    so = 0 if d in (None, 0) else int(np.prod(shape[d:]))
    assert strides == ((so,) * 4,) * w


def _bad(case):
    ps, gs, ms, vs = _slices((4, 16, 8), 1, 2)
    if case == "f16 param":
        ps = [p.to(torch.float16) for p in ps]
    elif case == "int grad":
        gs = [g.to(torch.int32) for g in gs]
    elif case == "f64 moment":
        ms = [m.double() for m in ms]
    elif case == "m and v differ":
        vs = [v.to(BF) for v in vs]
    elif case == "slices differ":
        gs = [gs[0], gs[1].to(BF)]
    elif case == "shapes differ":
        gs = [g[:, :4] for g in gs]
    elif case == "transposed grad":
        gs = [torch.zeros(4, 8, 8).transpose(1, 2) for _ in gs]
    elif case == "outer dims apart":
        ps, gs, ms, vs = _slices((2, 4, 16), 2, 2)
        ms = [torch.zeros(2, 3, 4, 8)[:, 1] for _ in ms]
        return ps, gs, ms, vs, 2
    elif case == "dim out of range":
        return ps, gs, ms, vs, 3
    elif case == "no slices":
        return [], [], [], [], 0
    return ps, gs, ms, vs, 1


@pytest.mark.parametrize("case,err", [
    ("f16 param", TypeError), ("int grad", TypeError), ("f64 moment", TypeError),
    ("m and v differ", TypeError), ("slices differ", TypeError),
    ("shapes differ", ValueError), ("transposed grad", ValueError),
    ("outer dims apart", ValueError), ("dim out of range", ValueError),
    ("no slices", ValueError)])
def test_layout_refuses(case, err):
    with pytest.raises(err):
        ak.layout(*_bad(case))


def test_outer_dims_that_fold_are_taken():
    """A view whose dims before the slice dim fold into one stride (a
    narrow of a contiguous leaf; a moment narrowed on a later dim) is
    taken with that stride."""
    m = torch.zeros(3, 5, 16, 8).narrow(2, 8, 8)
    assert ak._outer_stride(tuple(m.shape), m.stride(), 2, "m") == 128


@pytest.mark.parametrize("case", ["cpu", "momentum"])
def test_wrapper_refuses_before_building(case):
    ps, gs, ms, vs = _slices((4, 16), 0, 2)
    cfg, sc = ADAM, torch.zeros(4)
    if case == "momentum":
        cfg = dataclasses.replace(ADAM, kind="momentum")
    with pytest.raises(ValueError):
        ak.adam_update_cuda(ps, gs, ms, vs, sc, cfg, dim=0)


def _old_f32(x):
    return torch.tensor(x, dtype=F32)


def _old_lr(step, cfg):
    """``lr_schedule`` with its step made by ``torch.tensor``."""
    import math
    s = _old_f32(float(step))
    warm = torch.clamp(s / float(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((s - float(cfg.warmup_steps))
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


@pytest.mark.parametrize("step", [0, 1, 2, 7, 199, 10_001])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_step_scalars_keep_the_plain_bits(step, clip):
    cfg = dataclasses.replace(ADAM, grad_clip=clip, warmup_steps=200,
                              total_steps=10_000)
    for x in (float(step), 0.1, 1e-8, 3.0e38, -2.5):
        assert _same_bits(opt._f32(x, "cpu"), _old_f32(x))
    norm = torch.tensor(0.7312, dtype=F32)
    sc = opt.step_scalars(step, norm, cfg, "cpu")
    t = _old_f32(float(step)) + 1.0
    want = [_old_lr(step, cfg), 1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t),
            torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0) if clip
            else _old_f32(1.0)]
    assert sc.dtype == F32 and sc.shape == (4,)
    for got, w in zip(sc, want):
        assert _same_bits(got, w.reshape(()))
    assert _same_bits(opt.lr_schedule(step, cfg, "cpu"), _old_lr(step, cfg))


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

# (name, leaf shape, slice dim (None: replicated), W, moments sliced)
CASES = [("replicated", (37, 29), None, 1, False),
         ("dim0", (64, 24), 0, 2, False),
         ("dim0_w4_sliced", (36, 40), 0, 4, True),
         ("mid", (3, 16, 40), 1, 2, False),
         ("mid_ragged_sliced", (3, 10, 13), 1, 2, True),
         ("last", (4, 70, 96), 2, 2, False),
         ("last_ragged_sliced", (5, 9, 22), 2, 2, True),
         ("last_w4", (130, 68), 1, 4, False),
         ("w1", (20, 30), 1, 1, False)]
DTYPES = [(BF, BF, F32), (BF, BF, BF), (F32, F32, F32), (F32, F32, BF),
          (BF, F32, F32)]
# (step, clip at this share of the grad norm; 0: no clip)
STEPS = [(0, 0.5), (5, 10.0), (5, 0.5), (5, 0.0)]


def _leaf(rng, shape, dtype, dev, scale=1.0, positive=False):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    if positive:
        x = x * x
    return torch.from_numpy(x).to(dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("step,clip", STEPS, ids=[f"s{s}c{c}" for s, c in STEPS])
@pytest.mark.parametrize("pdt,gdt,mdt", DTYPES,
                         ids=["bf_bf_f32", "bf_bf_bf", "f32_f32_f32",
                              "f32_f32_bf", "bf_f32_f32"])
@pytest.mark.parametrize("name,shape,d,w,sliced", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_the_plain_update(cuda_dev, name, shape, d, w, sliced,
                                         pdt, gdt, mdt, step, clip):
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1] + step)
    p = _leaf(rng, shape, pdt, cuda_dev)
    g = _leaf(rng, shape, gdt, cuda_dev, 1e-2)
    m0 = _leaf(rng, shape, mdt, cuda_dev, 1e-3)
    v0 = _leaf(rng, shape, mdt, cuda_dev, 1e-3, positive=True)
    gnorm = opt.global_grad_norm([g])
    cfg = dataclasses.replace(ADAM, grad_clip=float(gnorm) * clip)
    lr = opt.lr_schedule(step, cfg, cuda_dev)
    gp = opt.clip_grads([g], gnorm, cfg.grad_clip)[0] if cfg.grad_clip else g
    sc = opt.step_scalars(step, gnorm, cfg, cuda_dev)
    dd = 0 if d is None else d
    blk = shape[dd] // w
    starts = [i * blk for i in range(w)]

    def moments(t):
        if sliced:
            return [t.narrow(dd, s, blk).clone() for s in starts]
        whole = t.clone()
        return [whole.narrow(dd, s, blk) for s in starts]

    mp, vp, mk, vk = moments(m0), moments(v0), moments(m0), moments(v0)
    want = []
    for i, s in enumerate(starts):
        p_s = p.narrow(dd, s, blk)
        new_p, st = opt.opt_leaf_update(p_s, gp.narrow(dd, s, blk),
                                        {"m": mp[i], "v": vp[i]}, lr, step, cfg)
        mp[i].copy_(st["m"])
        vp[i].copy_(st["v"])
        want.append(new_p if d is None else
                    (new_p - p_s).to(pdt).movedim(d, 0).contiguous())
    pk = p.clone()
    before = LAUNCHES["adam_update"]
    got = ak.adam_update_cuda([pk.narrow(dd, s, blk) for s in starts],
                              [g.narrow(dd, s, blk) for s in starts], mk, vk,
                              sc, cfg, dim=d)
    torch.cuda.synchronize()
    assert LAUNCHES["adam_update"] == before + 1
    if d is None:
        got = [pk]
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    for a, b in zip(mk + vk, mp + vp):
        assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("mdt", [F32, BF], ids=["f32", "bf16"])
def test_apply_update_kernel_matches_the_plain_path(cuda_dev, step, mdt):
    """A whole ZeRO-1 ``apply_update`` on ``LocalWorkers(2)``, bf16
    leaves (one replicated), the clip engaged: the kernel's leaves,
    moments and norm equal the plain path's bit for bit; one launch a
    leaf; the plain path counts its slices and the kernel's none."""
    rng = np.random.default_rng(5 + step)
    shapes = [(64, 48), (4, 40, 96), (96,), (3, 7), (2, 16, 24)]
    cfg = dataclasses.replace(ADAM, grad_clip=0.05,
                              state_dtype="bfloat16" if mdt == BF else "float32")
    tc = TrainConfig(workers=2, zero1=True, optimizer=cfg)
    leaves0 = [_leaf(rng, s, BF, cuda_dev) for s in shapes]
    grads = [_leaf(rng, s, BF, cuda_dev, 1e-2) for s in shapes]
    moms = {k: [_leaf(rng, s, mdt, cuda_dev, 1e-3, positive=k == "v")
                for s in shapes] for k in ("m", "v")}
    dims = zero1_dims(leaves0, tc)
    assert dims[3] is None and dims[1] == 2
    out = {}
    for policy in ("never", "auto"):
        leaves = [x.clone() for x in leaves0]
        state = TrainState(
            params=type("Params", (), {"leaves": lambda self, l=leaves: l})(),
            opt={k: [x.clone() for x in v] for k, v in moms.items()},
            residual=[], step=step)
        obs.enable(cuda_dev)
        obs.reset()
        try:
            gnorm = apply_update(state, grads, dims, LocalWorkers(2), cfg,
                                 use_pallas=policy)
            snap = obs.snapshot()
        finally:
            obs.disable()
            obs.reset()
        out[policy] = (leaves, state.opt, gnorm, snap["counters"])
    (lp, op, np_, cp), (lk, ok, nk, ck) = out["never"], out["auto"]
    assert _same_bits(np_, nk)
    for a, b in zip(lp, lk):
        assert _same_bits(a, b)
    for k in ("m", "v"):
        for a, b in zip(op[k], ok[k]):
            assert _same_bits(a, b)
    assert cp.get("optimizer/plain_slices") == 2 * 4 + 1
    assert "optimizer/plain_slices" not in ck
    assert ck.get("kernels/launches/adam_update") == len(shapes)
    assert "kernels/launches/adam_update" not in cp
