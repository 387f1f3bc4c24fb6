"""Fixed-size gradient buckets: the aggregation substrate.

``BucketPlan`` is the static geometry that fuses a list of gradient
leaves (in the reference's ``jax.tree.flatten`` order) into one flat f32
stream viewed as ``(n_buckets, bucket_elems)``:

- ``pack_flat`` — concatenate already-flat f32 leaves in order, pad,
  reshape;
- ``unpack`` — the exact inverse, restoring shapes and dtypes.

``bucket_elems`` is ``cfg.bucket_bytes`` rounded to the bucket quantum
(whole sketch blocks and whole bitmap words), so the stream's block ids,
and with them its hash plan, are the reference's. Per-bucket views
(``group_view``, ``residual_slices``) come with the streaming slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .config import CompressionConfig


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static packing of a leaf list into ``(n_buckets, bucket_elems)``."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]   # start of each leaf in the flat stream
    total: int                 # true element count (sum of sizes)
    bucket_elems: int
    n_buckets: int

    @property
    def padded(self) -> int:
        return self.n_buckets * self.bucket_elems

    @property
    def pad(self) -> int:
        return self.padded - self.total

    def pack_flat(self, flats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Already-flat leaves (in plan order) -> (n_buckets, E) f32."""
        if len(flats) != len(self.sizes):
            raise ValueError(f"{len(flats)} leaves, plan has {len(self.sizes)}")
        for f, n in zip(flats, self.sizes):
            if tuple(f.shape) != (n,):
                raise ValueError(f"leaf shape {tuple(f.shape)} != plan size ({n},)")
        stream = torch.cat([f.to(torch.float32) for f in flats])
        if self.pad:
            stream = F.pad(stream, (0, self.pad))
        return stream.reshape(self.n_buckets, self.bucket_elems)

    def unpack_flat(self, buckets: torch.Tensor) -> List[torch.Tensor]:
        """(n_buckets, E) -> list of flat f32 leaves (padding dropped)."""
        if tuple(buckets.shape) != (self.n_buckets, self.bucket_elems):
            raise ValueError(
                f"buckets shape {tuple(buckets.shape)} != "
                f"({self.n_buckets}, {self.bucket_elems})")
        stream = buckets.reshape(-1)
        return [stream[off:off + n] for off, n in zip(self.offsets, self.sizes)]

    def unpack(self, buckets: torch.Tensor) -> List[torch.Tensor]:
        """(n_buckets, E) f32 -> leaves with original shapes and dtypes."""
        return [f.to(dt).reshape(sh) for f, dt, sh in
                zip(self.unpack_flat(buckets), self.dtypes, self.shapes)]


def make_bucket_plan(leaves: Sequence[Any], cfg: CompressionConfig
                     ) -> BucketPlan:
    """Build the static plan from leaves in flatten order."""
    shape_list = [tuple(g.shape) for g in leaves]
    dtypes = tuple(g.dtype for g in leaves)
    sizes, offsets, off = [], [], 0
    for sh in shape_list:
        n = 1
        for d in sh:
            n *= d
        sizes.append(n)
        offsets.append(off)
        off += n
    bucket_elems = cfg.bucket_elems_for(off)
    return BucketPlan(
        shapes=tuple(shape_list), dtypes=dtypes, sizes=tuple(sizes),
        offsets=tuple(offsets), total=off, bucket_elems=bucket_elems,
        n_buckets=-(-off // bucket_elems))
