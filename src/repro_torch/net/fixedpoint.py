"""Fixed-point wire helpers for the sketch.

This slice carries only :func:`pow2`, which the plain quantize and
dequant legs of :mod:`repro_torch.kernels.ref` use to scale by exact
powers of two. The shared-exponent ``FixedPointWire`` codec comes with
the in-network slice.
"""

from __future__ import annotations

import torch


def pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**k`` for int32 ``k`` in [-126, 127].

    Built by writing the biased exponent field directly and reinterpreting
    the bits, never ``exp2``/``ldexp``, so the scale is exact on every
    backend.
    """
    k = torch.as_tensor(k, dtype=torch.int32)
    return ((k + 127) << 23).view(torch.float32)
