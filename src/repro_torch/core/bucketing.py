"""Fixed-size gradient buckets: the aggregation substrate.

``BucketPlan`` is the static geometry that fuses a list of gradient
leaves (in the reference's ``jax.tree.flatten`` order) into one flat f32
stream viewed as ``(n_buckets, bucket_elems)``:

- ``pack_flat`` — concatenate already-flat f32 leaves in order, pad,
  reshape;
- ``unpack`` — the exact inverse, restoring shapes and dtypes.

``bucket_elems`` is ``cfg.bucket_bytes`` rounded to the bucket quantum
(whole sketch blocks and whole bitmap words), so the stream's block ids,
and with them its hash plan, are the reference's, and the sketch and the
words slice into exact per-bucket views: what lets the stream scheduler
(:mod:`repro_torch.core.streams`) ship bucket i while bucket i+1 encodes.

Per-bucket views, as the reference's:

- ``bucket_segments`` — for each bucket, the runs of leaves that land in
  it (:class:`BucketSegment`);
- ``group_view`` — a plan over a run of buckets as one flat pseudo-leaf;
- ``residual_slices`` — one worker's error-feedback residual runs per
  bucket (the port keeps residuals as ``(local_workers, *shape)``).

:func:`make_dest_bucket_plans` is the all-to-all exchange's grid: one
plan a destination lane, all of one geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .config import CompressionConfig


@dataclasses.dataclass(frozen=True)
class BucketSegment:
    """One contiguous run of a leaf inside one bucket."""

    leaf: int          # index into the leaf list
    leaf_start: int    # offset into the leaf's flat vector
    bucket: int        # bucket index
    bucket_start: int  # offset into the bucket
    length: int


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

    def blocks_per_bucket(self, cfg: CompressionConfig) -> int:
        """Whole sketch blocks per bucket (exact: ``bucket_elems`` is a
        multiple of the bucket quantum)."""
        return self.bucket_elems // cfg.block_elems

    @property
    def words_per_bucket(self) -> int:
        """Whole packed-bitmap words per bucket (exact, likewise)."""
        return self.bucket_elems // 32

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

    # ---- per-bucket views ----------------------------------------------

    @property
    def bucket_segments(self) -> Tuple[Tuple[BucketSegment, ...], ...]:
        """For each bucket, the runs of leaves that land in it, in stream
        order. The padding tail is not a segment."""
        out: List[List[BucketSegment]] = [[] for _ in range(self.n_buckets)]
        for li, (off, n) in enumerate(zip(self.offsets, self.sizes)):
            pos = off
            while pos < off + n:
                b = pos // self.bucket_elems
                b_start = pos - b * self.bucket_elems
                length = min(off + n - pos, self.bucket_elems - b_start)
                out[b].append(BucketSegment(
                    leaf=li, leaf_start=pos - off, bucket=b,
                    bucket_start=b_start, length=length))
                pos += length
        return tuple(tuple(s) for s in out)

    def group_view(self, start: int, count: int) -> "BucketPlan":
        """A plan over buckets ``[start, start + count)`` as one flat f32
        pseudo-leaf, with this plan's ``bucket_elems`` and ``total`` cut
        at the stream's true element count (so the last group pads
        exactly where the full plan pads)."""
        if not (0 <= start and count >= 1
                and start + count <= self.n_buckets):
            raise ValueError(
                f"group [{start}, {start + count}) out of range for "
                f"{self.n_buckets} buckets")
        total = min(count * self.bucket_elems,
                    self.total - start * self.bucket_elems)
        return BucketPlan(
            shapes=((total,),), dtypes=(torch.float32,), sizes=(total,),
            offsets=(0,), total=total, bucket_elems=self.bucket_elems,
            n_buckets=count)

    def residual_slices(self, residual: Sequence[torch.Tensor],
                        worker: int = 0) -> List[List[torch.Tensor]]:
        """Local worker ``worker``'s error-feedback residual runs per
        bucket: for each bucket, one flat view per segment, from the
        ``(local_workers, *shape)`` residual of each leaf."""
        rows = [r[worker].reshape(-1) for r in residual]
        return [[rows[s.leaf][s.leaf_start:s.leaf_start + s.length]
                 for s in segs] for segs in self.bucket_segments]


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


def make_dest_bucket_plans(payload: Sequence[torch.Tensor],
                           cfg: CompressionConfig,
                           n_dests: int | None = None) -> Tuple[BucketPlan, ...]:
    """Per-destination bucket plans for the all-to-all pattern (the
    reference's): ``payload``'s leaves carry a leading destination axis
    (one slice a destination EP rank); returns one :class:`BucketPlan` a
    destination, built over the slices' shapes and shared by every lane,
    on the bucket grid of the aggregators. The exchange ships one stacked
    ``(W, n_buckets, E)`` payload, a lane a destination, so a ragged
    destination axis is rejected."""
    leaves = list(payload)
    if not leaves:
        raise ValueError("empty all-to-all payload")
    dests = {int(l.shape[0]) for l in leaves}
    if len(dests) != 1:
        raise ValueError(
            "all-to-all payload leaves disagree on the destination axis "
            f"(leading dim): {sorted(dests)}")
    W = dests.pop()
    if n_dests is not None and n_dests != W:
        raise ValueError(
            f"payload carries {W} destination slices but the exchange "
            f"has {n_dests} destination ranks")
    return (make_bucket_plan([l[0] for l in leaves], cfg),) * W
