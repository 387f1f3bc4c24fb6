"""Fixed-point homomorphic wire codec for the sketch.

A programmable switch aggregates with integer adds on 32-bit registers:
it cannot sum float32 sketch cells. :class:`FixedPointWire` is the
integer representation whose sums stay meaningful, field for field the
reference's ``repro.net.fixedpoint``:

- the sketch stream is viewed per aggregation bucket, ``(n_buckets, K)``;
- every worker derives a per-bucket exponent from its own slice
  (:meth:`FixedPointWire.bucket_exponents`, or from the producer
  kernel's per-block ``maxabs`` through
  :meth:`FixedPointWire.exponents_from_maxabs`), and the workers agree on
  the elementwise max (:meth:`FixedPointWire.shared_exponents`, a max
  over the workers of a ``repro_torch.core.collectives`` group), so every
  worker quantizes against the same scale;
- ``encode``: ``q = rint(y * 2^(M - e))`` as int32, ``M = mantissa_bits``;
- ``decode``: ``float32(q) * 2^(e - M)``.

``frexp`` gives ``max|y| < 2^e``, so ``|q| <= 2^M`` per worker, and with
``M = 30 - ceil_log2(W)`` a W-worker integer sum is bounded by
``W * 2^M <= 2^30``: no add in the tree can overflow int32. Exponents are
clamped to ``>= M - 126`` so the encode scale stays a normal float32;
the clamp also hides whether ``frexp`` flushes subnormal maxima (the
reference's reports ``-149`` for them, PyTorch's the true exponent: both
clamp to the same floor).

The documented aggregate is ``decode(sum_w encode(y_w, e), e)`` with
``e = max_w exponents(y_w)``; the integer sum is exact in any order, so
its only roundings are ``rint`` at encode (half to even, as
``torch.round``) and the float32 cast of the summed integer at decode.
Scales are powers of two written into the exponent field (:func:`pow2`),
never ``exp2``/``ldexp``, so the scaling itself is exact. The CUDA
kernels' quantize and dequant legs (:mod:`repro_torch.kernels.sketch_wire`)
fuse ``encode`` into the producer and ``decode`` into the consumer with
the same arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch


def ceil_log2(n: int) -> int:
    """Smallest k with 2**k >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    return int(n - 1).bit_length()


def pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**k`` for int32 ``k`` in [-126, 127].

    Built by writing the biased exponent field directly and reinterpreting
    the bits, never ``exp2``/``ldexp``, so the scale is exact on every
    backend.
    """
    k = torch.as_tensor(k, dtype=torch.int32)
    return ((k + 127) << 23).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class FixedPointWire:
    """Shared-exponent int32 wire for ``workers``-way sketch sums."""

    workers: int

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.mantissa_bits < 2:
            raise ValueError(
                f"workers={self.workers} leaves {self.mantissa_bits} "
                "mantissa bits; the fixed-point wire needs at least 2")

    def with_workers(self, workers: int) -> "FixedPointWire":
        """The same wire re-priced for another number of workers. The
        mantissa budget depends on W, so crossing a power of two changes
        the wire: payloads of two budgets must never be mixed."""
        return dataclasses.replace(self, workers=workers)

    @property
    def headroom_bits(self) -> int:
        """Bits reserved so W-worker sums cannot overflow int32."""
        return ceil_log2(self.workers)

    @property
    def mantissa_bits(self) -> int:
        """M, the value bits per worker: |q| <= 2^M, W * 2^M <= 2^30."""
        return 30 - self.headroom_bits

    @property
    def min_exponent(self) -> int:
        """Exponent floor keeping the encode scale 2^(M-e) normal."""
        return self.mantissa_bits - 126

    def exponents_from_maxabs(self, maxabs: torch.Tensor) -> torch.Tensor:
        """int32 exponents from precomputed max magnitudes. ``max`` is
        exact, so the max of the producer's per-block maxima over a
        bucket gives the bucket's exponent bit for bit. A zero maximum
        (an all-zero slice, common under top-k) reports
        :attr:`min_exponent`, not frexp's 0, so that it never inflates
        the shared exponent."""
        maxabs = torch.as_tensor(maxabs, dtype=torch.float32)
        e = torch.frexp(maxabs).exponent.to(torch.int32)
        floor = torch.full_like(e, self.min_exponent)
        return torch.maximum(torch.where(maxabs == 0, floor, e), floor)

    def bucket_exponents(self, buckets: torch.Tensor) -> torch.Tensor:
        """Per-bucket exponent of one worker's slice, ``(nb, K) -> (nb,)``."""
        return self.exponents_from_maxabs(
            buckets.to(torch.float32).abs().amax(dim=-1))

    def shared_exponents(self, worker_buckets: Sequence[torch.Tensor],
                         group) -> torch.Tensor:
        """The exponents every worker quantizes against: the max over the
        workers of ``group`` of each one's :meth:`bucket_exponents`."""
        return group.max([self.bucket_exponents(b) for b in worker_buckets])

    def encode(self, buckets: torch.Tensor,
               exponents: torch.Tensor) -> torch.Tensor:
        """``(nb, K) f32 -> (nb, K) int32`` against shared exponents."""
        scale = pow2(self.mantissa_bits - exponents.to(torch.int32))[..., None]
        return torch.round(buckets.to(torch.float32) * scale).to(torch.int32)

    def decode(self, q: torch.Tensor, exponents: torch.Tensor) -> torch.Tensor:
        """``(nb, K) int32 (summed) -> (nb, K) f32``."""
        scale = pow2(exponents.to(torch.int32) - self.mantissa_bits)[..., None]
        return q.to(torch.float32) * scale

    def roundtrip_reference(self, worker_buckets) -> torch.Tensor:
        """The documented aggregate: quantize every worker's ``(nb, K)``
        slice against the shared exponents, integer-sum, dequantize. The
        ``compressed_innet`` fxp32 wire must equal it bit for bit."""
        worker_buckets = [torch.as_tensor(b, dtype=torch.float32)
                          for b in worker_buckets]
        if len(worker_buckets) > self.workers:
            raise ValueError(
                f"{len(worker_buckets)} summands on a wire sized for "
                f"{self.workers} workers (overflow bound would not hold)")
        e = functools.reduce(torch.maximum,
                             [self.bucket_exponents(b) for b in worker_buckets])
        q = functools.reduce(torch.add,
                             [self.encode(b, e) for b in worker_buckets])
        return self.decode(q, e)
