"""The plain reference of a training cell: the decoder LM, its loss and
gradients, per-worker top-k with error feedback, the mean over the
workers, global-norm clipping and AdamW, written out in plain PyTorch.

It follows the semantics of the configuration and the mix, not the
program's code: the model in float32 (TF32 off) from the bf16 values
the benchmark made (:func:`make_params`), the weights stored back in
their dtype after each update, as the configuration states, and the
aggregate the lossless mean of the workers' sparse gradients.

``prec="fp8"`` is the control: every product's operands and result
rounded to float8 (e4m3 forward, e5m2 backward), each with a per-tensor
scale, where the program rounds them to bf16; the rest unchanged.

Faults for the checks of the check (``fault=``): ``"half_batch"`` (each
worker's loss over the first half of its rows), ``"no_exchange"`` (each
worker's aggregate its own sparse gradient over W).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Layout = List[Tuple[str, Tuple[int, ...], torch.dtype, int]]


# ----------------------------------------------------------------------
# Parameters: the layout and the seeded values, shared by both sides
# ----------------------------------------------------------------------

def layout(cfg: Dict) -> Layout:
    """``(path, shape, dtype, fan_in)`` of every leaf, sorted by path
    (``/``-joined, layers stacked on dim 0); fan_in 0 marks a norm's
    scale (ones). A tied head is the embedding's transpose: no
    ``lm_head`` leaf."""
    L, D, H, KV = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    Vp = -(-cfg["vocab"] // 128) * 128
    bf, f32 = torch.bfloat16, torch.float32
    dt = bf if cfg.get("dtype", "bfloat16") == "bfloat16" else f32
    leaves = [("embed", (Vp, D), dt, D), ("final_norm/scale", (D,), f32, 0),
              ("layers/attn/wq", (L, D, H * hd), dt, D),
              ("layers/attn/wk", (L, D, KV * hd), dt, D),
              ("layers/attn/wv", (L, D, KV * hd), dt, D),
              ("layers/attn/wo", (L, H * hd, D), dt, H * hd),
              ("layers/ln1/scale", (L, D), f32, 0),
              ("layers/ln2/scale", (L, D), f32, 0)]
    if not cfg.get("tie_embeddings"):
        leaves.append(("lm_head", (D, Vp), dt, D))
    moe = cfg.get("moe")
    if moe:
        E, f, s = moe["num_experts"], moe["expert_d_ff"], moe["shared_experts"]
        leaves += [("layers/moe/router", (L, D, E), f32, D),
                   ("layers/moe/we_gate", (L, E, D, f), dt, D),
                   ("layers/moe/we_up", (L, E, D, f), dt, D),
                   ("layers/moe/we_down", (L, E, f, D), dt, f)]
        if s:
            leaves += [("layers/moe/shared/w_gate", (L, D, s * f), dt, D),
                       ("layers/moe/shared/w_up", (L, D, s * f), dt, D),
                       ("layers/moe/shared/w_down", (L, s * f, D), dt, s * f)]
    else:
        F_ = cfg["d_ff"]
        leaves += [("layers/ffn/w_gate", (L, D, F_), dt, D),
                   ("layers/ffn/w_up", (L, D, F_), dt, D),
                   ("layers/ffn/w_down", (L, F_, D), dt, F_)]
    return sorted(leaves, key=lambda t: t[0].split("/"))


def make_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves from ``seed``, made on ``device`` by one generator: one
    uniform(-1, 1) draw for all leaves of each dtype, each leaf's view
    then scaled by ``1/sqrt(fan_in)``; the norms' scales ones."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lay = layout(cfg)
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
# Products, in float32 or (the control) float8
# ----------------------------------------------------------------------

def _fake_quant(x: torch.Tensor, dtype) -> torch.Tensor:
    fmax = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / fmax
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` in float8 where the program works in bf16: the operands
    and the product e4m3, the backward's incoming gradient and its two
    products e5m2 (f32 accumulation throughout). ``b`` is a 2-D weight
    or a batch of matrices shaped as ``a``."""

    @staticmethod
    def forward(ctx, a, b):
        e4 = torch.float8_e4m3fn
        qa, qb = _fake_quant(a, e4), _fake_quant(b, e4)
        ctx.save_for_backward(qa, qb)
        return _fake_quant(qa @ qb, e4)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        e5 = torch.float8_e5m2
        qg = _fake_quant(g, e5)
        da = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            db = qa.transpose(-1, -2) @ qg
        return _fake_quant(da, e5), _fake_quant(db, e5)


def _mm(a, b, prec):
    return _Fp8Matmul.apply(a, b) if prec == "fp8" else a @ b


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """Rotary embedding on (B, S, heads, hd): the two halves of each
    head rotated by position x frequency."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(h, P, l, cfg, prec):
    B, S, D = h.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    q = _mm(h, P["layers/attn/wq"][l], prec).view(B, S, H, hd)
    k = _mm(h, P["layers/attn/wk"][l], prec).view(B, S, KV, hd)
    v = _mm(h, P["layers/attn/wv"][l], prec).view(B, S, KV, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    k, v = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in (k, v))
    s = _mm(q.transpose(1, 2), k.transpose(-1, -2), prec) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    o = _mm(p, v, prec).transpose(1, 2).reshape(B, S, H * hd)
    return _mm(o, P["layers/attn/wo"][l], prec)


def _swiglu(x, gate, up, down, prec):
    return _mm(F.silu(_mm(x, gate, prec)) * _mm(x, up, prec), down, prec)


def _moe(h, P, l, cfg, prec):
    """Top-k routing with the weights renormalised, each expert taking at
    most ``C = ceil(T·K·cf/E)`` tokens in token order (later ones
    dropped), the shared experts on every token, and the load-balance
    term ``E · sum_e (share of choices_e) · (mean probability_e)``."""
    m = cfg["moe"]
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    T, E, K = x.shape[0], m["num_experts"], m["top_k"]
    C = max(1, math.ceil(T * K * m["capacity_factor"] / E))
    probs = torch.softmax(_mm(x, P["layers/moe/router"][l], prec), dim=-1)
    w, idx = torch.topk(probs, K, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = torch.zeros(T, E, dtype=torch.int64, device=x.device).scatter_(1, idx, 1)
    rank = (chosen.cumsum(0) - 1).gather(1, idx)
    keep = rank < C
    out = torch.zeros_like(x)
    for e in range(E):
        t, kk = torch.nonzero((idx == e) & keep, as_tuple=True)
        if t.numel():
            y = _swiglu(x[t], P["layers/moe/we_gate"][l, e], P["layers/moe/we_up"][l, e],
                        P["layers/moe/we_down"][l, e], prec)
            out = out.index_add(0, t, y * w[t, kk][:, None])
    if m["shared_experts"]:
        out = out + _swiglu(x, P["layers/moe/shared/w_gate"][l], P["layers/moe/shared/w_up"][l],
                            P["layers/moe/shared/w_down"][l], prec)
    frac = chosen.sum(0).to(torch.float32) / (T * K)
    aux = E * (frac * probs.mean(0)).sum()
    return out.reshape(B, S, D), aux


def loss_fn(P: Dict[str, torch.Tensor], cfg: Dict, tokens, labels, prec="f32"):
    """Mean next-token cross entropy + ``1e-4`` x mean squared
    log-partition + the configuration's ``router_aux_coef`` x the
    load-balance terms."""
    eps = cfg["norm_eps"]
    x = P["embed"][tokens]
    aux = x.new_zeros(())
    for l in range(cfg["n_layers"]):
        x = x + _attention(_rmsnorm(x, P["layers/ln1/scale"][l], eps), P, l, cfg, prec)
        h = _rmsnorm(x, P["layers/ln2/scale"][l], eps)
        if cfg.get("moe"):
            y, a = _moe(h, P, l, cfg, prec)
            aux = aux + a
        else:
            y = _swiglu(h, P["layers/ffn/w_gate"][l], P["layers/ffn/w_up"][l],
                        P["layers/ffn/w_down"][l], prec)
        x = x + y
    x = _rmsnorm(x, P["final_norm/scale"], eps)
    head = P["embed"].T if cfg.get("tie_embeddings") else P["lm_head"]
    logits = _mm(x, head, prec)
    V = cfg["vocab"]
    logits = torch.cat([logits[..., :V], torch.full_like(logits[..., V:], -1e30)], dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    coef = cfg["moe"]["router_aux_coef"] if cfg.get("moe") else 0.0
    return (lse - ll).mean() + 1e-4 * lse.square().mean() + coef * aux


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
