"""Optimizers (AdamW, SGD-momentum) with dtype-configurable moments, plus
the warmup-cosine schedule and global-norm clipping.

The update is elementwise per leaf and computed in float32 in the
reference's operation order (scalars enter as float32, as JAX's weakly
typed Python scalars do), so the f32 parity tests can hold the port to
the reference's losses.

On the card, AdamW runs as one hand kernel a leaf
(``kernels/adam_update.py``; :func:`fused_adamw` says where): the same
clip and update in the same order, bit for bit, with the step's scalars
from :func:`step_scalars`. The scalars are made on the device by fill
kernels (:func:`_f32`), never copied from the host, so neither path
blocks the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"           # "adamw" | "momentum"
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # moments dtype ("bfloat16" for 1T-scale)

    @property
    def _sdt(self) -> torch.dtype:
        return torch.bfloat16 if self.state_dtype == "bfloat16" else torch.float32


def _f32(x: float, device) -> torch.Tensor:
    """``x`` as a float32 scalar on ``device``, by a fill kernel (the
    bits ``torch.tensor(x, dtype=float32)`` has, without a blocking copy
    from the host)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_schedule(step: int, cfg: OptimizerConfig, device=None) -> torch.Tensor:
    """Warmup then cosine decay to ``min_lr_frac * lr``; float32 scalar."""
    s = _f32(float(step), device)
    warm = torch.clamp(s / float(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((s - float(cfg.warmup_steps))
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(leaves: Sequence[torch.Tensor], cfg: OptimizerConfig,
                   shapes: Sequence[Sequence[int]] | None = None
                   ) -> Dict[str, List[torch.Tensor]]:
    """Zero moments on each leaf's device, of the leaf's shape or of
    ``shapes[i]`` (a rank's ZeRO-1 slice)."""
    shapes = [p.shape for p in leaves] if shapes is None else shapes

    def zeros():
        return [torch.zeros(tuple(sh), dtype=cfg._sdt, device=p.device)
                for p, sh in zip(leaves, shapes)]
    if cfg.kind == "adamw":
        return {"m": zeros(), "v": zeros()}
    if cfg.kind == "momentum":
        return {"m": zeros()}
    raise ValueError(cfg.kind)


def opt_leaf_update(p: torch.Tensor, g: torch.Tensor,
                    state: Dict[str, torch.Tensor], lr: torch.Tensor,
                    step: int, cfg: OptimizerConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Elementwise update of one leaf -> (new param, new moments)."""
    g = g.to(torch.float32)
    pf = p.to(torch.float32)
    if cfg.kind == "adamw":
        m = state["m"].to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v = state["v"].to(torch.float32) * cfg.b2 + g.square() * (1 - cfg.b2)
        t = _f32(float(step), p.device) + 1.0
        mh = m / (1 - torch.pow(cfg.b1, t))
        vh = v / (1 - torch.pow(cfg.b2, t))
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        new_p = (pf - lr * upd).to(p.dtype)
        return new_p, {"m": m.to(state["m"].dtype), "v": v.to(state["v"].dtype)}
    m = state["m"].to(torch.float32) * cfg.momentum + g
    new_p = (pf - lr * m).to(p.dtype)
    return new_p, {"m": m.to(state["m"].dtype)}


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    sq = sum(g.to(torch.float32).square().sum() for g in grads)
    return torch.sqrt(sq)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_grads(grads: Sequence[torch.Tensor], norm: torch.Tensor,
               max_norm: float) -> List[torch.Tensor]:
    scale = clip_scale(norm, max_norm)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads]


def fused_adamw(cfg: OptimizerConfig, device, use_pallas: str = "auto") -> bool:
    """Whether a leaf on ``device`` takes the hand AdamW kernel: AdamW on
    a CUDA device unless the policy is ``"never"`` (the compression
    config's ``use_pallas``, read as the codec's dispatch reads it, so
    ``"always"`` raises off the card). The CPU, ``"never"`` and
    ``momentum`` take :func:`opt_leaf_update`."""
    if cfg.kind != "adamw" or use_pallas == "never":
        return False
    if torch.device(device).type == "cuda":
        return True
    if use_pallas == "always":
        raise ValueError("use_pallas='always' needs a CUDA tensor: the hand "
                         "AdamW kernel exists only on the card")
    return False


def step_scalars(step: int, norm: torch.Tensor, cfg: OptimizerConfig,
                 device) -> torch.Tensor:
    """The hand kernel's (4,) float32 step scalars on ``device``: the lr,
    ``1 - b1^t``, ``1 - b2^t`` and the clip scale (1 without clipping),
    by the expressions :func:`opt_leaf_update` and :func:`clip_grads`
    evaluate, so with the same bits."""
    t = _f32(float(step), device) + 1.0
    scale = (clip_scale(norm, cfg.grad_clip) if cfg.grad_clip
             else _f32(1.0, device))
    return torch.stack([lr_schedule(step, cfg, device),
                        1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t),
                        scale])
