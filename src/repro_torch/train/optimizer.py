"""Optimizers (AdamW, SGD-momentum) with dtype-configurable moments, plus
the warmup-cosine schedule and global-norm clipping.

The update is elementwise per leaf and computed in float32 in the
reference's operation order (scalars enter as float32, as JAX's weakly
typed Python scalars do), so the f32 parity tests can hold the port to
the reference's losses.
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
    return torch.tensor(x, dtype=torch.float32, device=device)


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


def clip_grads(grads: Sequence[torch.Tensor], norm: torch.Tensor,
               max_norm: float) -> List[torch.Tensor]:
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads]
