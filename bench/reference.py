"""The plain reference of a training cell: the configuration's model
(its module of ``refmodels``, which gives the parameters' layout and the
loss), per-worker top-k with error feedback, the mean over the workers,
global-norm clipping and AdamW, written out in plain PyTorch. The
pieces every model module shares (the products, RMSNorm, rotary
embeddings) are in ``modelparts``.

It follows the semantics of the configuration and the mix, not the
program's code: the model in float32 (TF32 off) from the bf16 values
the benchmark made (:func:`make_params`), the weights stored back in
their dtype after each update, as the configuration states, and the
aggregate the lossless mean of the workers' sparse gradients.

``prec="fp8"`` is the control (``modelparts.mm``): every product in
float8 where the program works in bf16; the rest unchanged.

Faults for the checks of the check (``fault=``): ``"half_batch"`` (each
worker's loss over the first half of its rows), ``"no_exchange"`` (each
worker's aggregate its own sparse gradient over W).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

import refmodels


# ----------------------------------------------------------------------
# Parameters: the seeded values of the model's layout, shared by both sides
# ----------------------------------------------------------------------

def make_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves from ``seed``, made on ``device`` by one generator: one
    uniform(-1, 1) draw for all leaves of each dtype, each leaf's view
    then scaled by ``1/sqrt(fan_in)``; the norms' scales ones. The
    leaves are those of the model's ``layout``, in its order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lay = refmodels.for_config(cfg).layout(cfg)
    out: Dict[str, torch.Tensor] = {}
    for dtype in (torch.bfloat16, torch.float32):
        mine = [t for t in lay if t[2] == dtype and t[3]]
        total = sum(math.prod(s) for _, s, _, _ in mine)
        if not total:
            continue
        flat = torch.empty(total, dtype=dtype, device=device)
        flat.uniform_(-1.0, 1.0, generator=gen)
        off = 0
        for path, shape, _, fan in mine:
            n = math.prod(shape)
            out[path] = flat[off:off + n].view(shape).mul_(1.0 / math.sqrt(fan))
            off += n
    for path, shape, dtype, fan in lay:
        if not fan:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
    return {p: out[p] for p, _, _, _ in lay}


def make_batches(cfg: Dict, global_batch: int, seq_len: int, seed: int,
                 steps: Sequence[int]) -> List[Dict[str, torch.Tensor]]:
    """Each step's tokens and labels, ids uniform over the vocabulary:
    ``seq_len + 1`` ids a row from numpy's generator on ``(seed, step,
    0xDA7A)``, the tokens the first ``seq_len``, the labels the last."""
    import numpy as np
    out = []
    for step in steps:
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(step), 0xDA7A]))
        ids = rng.integers(0, cfg["vocab"], (global_batch, seq_len + 1), dtype=np.int32)
        t = torch.from_numpy(ids.astype(np.int64))
        out.append({"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()})
    return out


# ----------------------------------------------------------------------
# The step: sparsify with error feedback, the mean, clipping, AdamW
# ----------------------------------------------------------------------

def sparsify(full: torch.Tensor, ratio: float, exact: bool) -> torch.Tensor:
    """The ``ratio`` largest magnitudes of flat ``full``: exactly
    (``exact``), or above the linear quantile ``1 - k/n`` of every
    ``n // 4096``-th magnitude."""
    n = full.numel()
    k = max(1, int(n * ratio))
    if k >= n:
        return full
    a = full.abs()
    if exact:
        t = torch.topk(a, k).values[-1]
    else:
        sample = a[::max(1, n // 4096)].double()
        t = torch.quantile(sample, 1.0 - k / n).to(torch.float32)
    return torch.where(a >= t, full, torch.zeros_like(full))


def lr_at(step: int, opt: Dict) -> float:
    """Linear warm-up to ``lr``, then cosine decay to ``min_lr_frac``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def train_readings(cfg: Dict, mix: Dict, seed: int, batches, device, prec="f32",
                   fault=None) -> Dict[str, list]:
    """Run the mix's first ``len(batches)`` steps from the seeded
    parameters: each step's loss (the workers' mean), each leaf's norm of
    the first step's clipped gradient, each leaf's norm of the change of
    the parameters over all the steps (float32 of the stored values)."""
    mm_tf32, cudnn_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _readings(cfg, mix, seed, batches, device, prec, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm_tf32, cudnn_tf32


def _readings(cfg, mix, seed, batches, device, prec, fault):
    W, comp, opt = mix["workers"], mix["compression"], mix["optimizer"]
    loss_fn = refmodels.for_config(cfg).loss_fn
    stored = make_params(cfg, seed, device)
    paths = list(stored)
    dtypes = [t.dtype for t in stored.values()]
    start = [t.clone() for t in stored.values()]
    cur = list(stored.values())
    del stored
    ef = comp.get("error_feedback", True)
    res = [[torch.zeros(t.shape, dtype=torch.float32, device=device) for t in cur]
           for _ in range(W)] if ef else None
    m = [torch.zeros(t.shape, dtype=torch.float32, device=device) for t in cur]
    v = [torch.zeros_like(x) for x in m]
    losses, first = [], None
    for step, batch in enumerate(batches):
        per = batch["tokens"].shape[0] // W
        total = [torch.zeros(t.shape, dtype=torch.float32, device=device) for t in cur]
        loss_sum = 0.0
        for w in range(W):
            rows = slice(w * per, w * per + (per // 2 if fault == "half_batch" else per))
            P = {p: t.detach().to(torch.float32, copy=True).requires_grad_()
                 for p, t in zip(paths, cur)}
            loss = loss_fn(P, cfg, batch["tokens"][rows].to(device),
                           batch["labels"][rows].to(device), prec)
            grads = torch.autograd.grad(loss, list(P.values()))
            loss_sum += float(loss.detach())
            del P, loss
            with torch.no_grad():
                _accumulate(grads, res[w] if ef else None, total, comp,
                            fault != "no_exchange" or w == 0)
            del grads
        losses.append(loss_sum / W)
        with torch.no_grad():
            g = _clipped_mean(total, dtypes, W, opt.get("grad_clip"))
            del total
            if first is None:
                first = [float(x.norm()) for x in g]
            _adamw(cur, g, m, v, dtypes, step, opt)
        del g
    change = [float((c.to(torch.float32) - s.to(torch.float32)).norm())
              for c, s in zip(cur, start)]
    return {"paths": paths, "losses": losses, "grad": first, "change": change}


def _accumulate(grads, res, total, comp, send):
    """One worker's sparse gradients (its residuals updated) added into
    ``total`` where ``send``."""
    for i, g in enumerate(grads):
        full = g.reshape(-1) + res[i].reshape(-1) if res is not None else g.reshape(-1)
        sparse = sparsify(full, comp["topk_ratio"], comp.get("topk_exact", False)) \
            if comp.get("topk_ratio") is not None else full
        if res is not None:
            res[i].copy_((full - sparse).view(res[i].shape))
        if send:
            total[i].add_(sparse.view(total[i].shape))


def _clipped_mean(total, dtypes, W, clip):
    """The sum over W workers as the mean in each leaf's dtype, scaled to
    a global norm of at most ``clip``."""
    agg = [(t / W).to(dt).to(torch.float32) for t, dt in zip(total, dtypes)]
    gnorm = math.sqrt(sum(float(a.double().square().sum()) for a in agg))
    scale = min(1.0, clip / max(gnorm, 1e-9)) if clip else 1.0
    return [(a * scale).to(dt).to(torch.float32) for a, dt in zip(agg, dtypes)]


def _adamw(cur, g, m, v, dtypes, step, opt):
    """One AdamW update of the stored leaves ``cur`` (replaced, in their
    dtypes) and the f32 moments (in place)."""
    lr, t = lr_at(step, opt), step + 1
    b1, b2 = opt["b1"], opt["b2"]
    for i, gi in enumerate(g):
        m[i].mul_(b1).add_(gi * (1 - b1))
        v[i].mul_(b2).add_(gi.square() * (1 - b2))
        pf = cur[i].to(torch.float32)
        upd = (m[i] / (1 - b1 ** t)) / ((v[i] / (1 - b2 ** t)).sqrt() + opt["eps"]) \
            + opt["weight_decay"] * pf
        cur[i] = (pf - lr * upd).to(dtypes[i])


# ----------------------------------------------------------------------
# The comparison
# ----------------------------------------------------------------------

def _leaf_gap(prog: Sequence[float], ref: Sequence[float], counted) -> Tuple[float, int]:
    med = sorted(ref)[len(ref) // 2]
    best = (0.0, -1)
    for i, (p, r) in enumerate(zip(prog, ref)):
        if counted[i]:
            best = max(best, (abs(p - r) / max(r, med, 1e-30), i))
    return best


def compare(prog: Dict[str, list], ref: Dict[str, list]) -> Dict[str, dict]:
    """The numbers compared: the worst step's loss gap over the
    reference's loss, and for the first gradient and the change the
    worst leaf's gap of norms over the larger of the reference leaf's
    norm and the median leaf's. The change leaves out leaves whose
    reference gradient is under a thousandth of the median leaf's
    (named under ``left_out``)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = sorted(ref["grad"])[len(ref["grad"]) // 2]
    moved = [g >= 1e-3 * med for g in ref["grad"]]
    grad, gi = _leaf_gap(prog["grad"], ref["grad"], [True] * len(moved))
    change, ci = _leaf_gap(prog["change"], ref["change"], moved)
    paths = ref["paths"]
    return {"loss_gap": {"value": loss},
            "grad_gap": {"value": grad, "leaf": paths[gi]},
            "change_gap": {"value": change, "leaf": paths[ci] if ci >= 0 else None,
                           "left_out": [p for p, m in zip(paths, moved) if not m]}}
