"""Magnitude sparsification + error feedback.

For dense-gradient models the sketch has a static capacity, so each leaf
keeps its top ``topk_ratio`` coordinates and carries the remainder in an
error-feedback accumulator (DGC-style).

The default threshold path reproduces the reference's ``jnp.quantile``
(linear interpolation) on the strided sample bit for bit. It writes out
JAX's formula, ``low * (1 - w) + high * w`` in float32 with the final
multiply-add fused as XLA's CPU backend fuses it, rather than calling
``torch.quantile``, whose ``lerp`` rounds differently and can move the
threshold by an ulp.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sparsify_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-magnitude entries of flat ``x`` (ties kept)."""
    if k >= x.shape[0]:
        return x
    thresh = torch.topk(x.abs(), k, sorted=True).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def quantile_linear(sample: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(sample, q)`` (method 'linear') on a 1-D float32
    tensor, computed in float32 in the same operation order."""
    a = torch.sort(sample).values
    n = a.shape[0]
    f32 = dict(dtype=torch.float32, device=a.device)
    pos = torch.tensor(q, **f32) * torch.tensor(float(n - 1), **f32)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo = low.clamp(0, n - 1).long()
    hi = high.clamp(0, n - 1).long()
    # XLA contracts ``low*lw + high*hw`` into fma(high, hw, low*lw): one
    # rounding of the exact sum. The f32 x f32 product is exact in float64
    # and so is its sum with one f32 here, so rounding once reproduces it.
    low_part = (a[lo] * lw).to(torch.float64)
    return (a[hi].to(torch.float64) * hw.to(torch.float64) + low_part
            ).to(torch.float32)


def sparsify_threshold(x: torch.Tensor, k: int, oversample: int = 4096) -> torch.Tensor:
    """Approximate top-k via a sampled quantile threshold: O(n), about k
    survivors; the compressor tolerates overshoot via its peel fallback."""
    n = x.shape[0]
    if k >= n:
        return x
    stride = max(1, n // oversample)
    thresh = quantile_linear(x[::stride].abs(), 1.0 - (k / n))
    return torch.where(x.abs() >= thresh, x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def apply_error_feedback(grad: torch.Tensor, residual: torch.Tensor,
                         k: int, exact: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad + residual) -> (sparse part to send, new residual)."""
    full = grad + residual
    sparse = sparsify_topk(full, k) if exact else sparsify_threshold(full, k)
    return sparse, full - sparse
