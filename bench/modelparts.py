"""The pieces that every reference model of ``refmodels`` shares: the
products in float32 or as the float8 control, RMSNorm and rotary
embeddings. A leaf: it imports nothing of the benchmark, so a model
module builds on it without importing ``reference``, which imports the
model modules.

``prec="fp8"`` is the control: every product's operands and result
rounded to float8 (e4m3 forward, e5m2 backward), each with a per-tensor
scale, where the program rounds them to bf16.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

# (path, shape, dtype, fan_in) of every trained leaf of a model
Layout = List[Tuple[str, Tuple[int, ...], torch.dtype, int]]


# ----------------------------------------------------------------------
# Products, in float32 or (the control) float8
# ----------------------------------------------------------------------

def fake_quant(x: torch.Tensor, dtype) -> torch.Tensor:
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
        qa, qb = fake_quant(a, e4), fake_quant(b, e4)
        ctx.save_for_backward(qa, qb)
        return fake_quant(qa @ qb, e4)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        e5 = torch.float8_e5m2
        qg = fake_quant(g, e5)
        da = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            db = qa.transpose(-1, -2) @ qg
        return fake_quant(da, e5), fake_quant(db, e5)


def mm(a, b, prec):
    return _Fp8Matmul.apply(a, b) if prec == "fp8" else a @ b


# ----------------------------------------------------------------------
# The pieces of a model: norms and positions
# ----------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Rotary embedding on (B, S, heads, hd): the two halves of each
    head rotated by position x frequency."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
