"""The rank grid: ``W`` data-parallel indices times ``MP`` model-parallel
ones, the counterpart of the reference's ``launch/mesh.py``.

The model axis is innermost: global rank ``d·MP + t`` is data index
``d``, model index ``t``, the device order of the reference's
``make_mesh((data, model_parallel))``. :func:`make_host_mesh` builds a
rank's :class:`RankMesh`: its coordinates, its data-parallel group (the
W ranks of its model index, on which the gradients aggregate) and its
model-axis group (the MP ranks of its data index, on which the
tensor-parallel layers reduce). :func:`make_production_mesh` gives the
reference's production shape only (16 x 16 chips a pod): the port
cannot spawn 256 ranks, and its dry run reads the shape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.core.collectives import ProcessGroupWorkers


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes, outermost first (the reference's
    ``Mesh.shape``)."""

    shape: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        """The first device's coordinates (a shape has no ranks)."""
        return {a: 0 for a in self.shape}

    def group(self, axes: Sequence[str]):
        """None where ``axes`` span one device; a shape holds no process
        groups, so any larger span raises."""
        if math.prod(self.shape.get(a, 1) for a in axes) > 1:
            raise ValueError(f"a mesh shape has no process group for the "
                             f"axes {tuple(axes)}; use a RankMesh")
        return None


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place on the ``(data, model)`` grid."""

    shape: Dict[str, int]            # {"data": W, "model": MP}
    coords: Dict[str, int]           # this rank's index on each axis
    rank: int                        # global rank, d·MP + t
    data: ProcessGroupWorkers        # the W ranks of this model index
    model: Optional[ProcessGroupWorkers]   # the MP ranks of this data
                                           # index (None when MP == 1)
    grid: Optional[ProcessGroupWorkers] = None   # all W·MP ranks, in
                                                 # rank order d·MP + t

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ only in ``axes``
        (this rank's index in it rank-major over them, as a spec's tuple
        of axes blocks a dim): ``data``, ``model`` or both (the grid);
        None where they span one rank."""
        axes = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        if not axes:
            return None
        if axes == ("data",):
            return self.data
        if axes == ("model",):
            return self.model
        if axes == ("data", "model"):
            return self.grid
        raise ValueError(f"no group for the axes {axes} of {self.shape}")


def grid_ranks(data: int, model: int) -> Tuple[Tuple[Tuple[int, ...], ...],
                                               Tuple[Tuple[int, ...], ...]]:
    """(the data-parallel groups, one a model index; the model-axis
    groups, one a data index), each group's global ranks in index order."""
    dp = tuple(tuple(d * model + t for d in range(data)) for t in range(model))
    mp = tuple(tuple(d * model + t for t in range(model)) for d in range(data))
    return dp, mp


def make_host_mesh(model_parallel: int = 1,
                   levels: Sequence[int] = ()) -> RankMesh:
    """The grid over this job's ranks (an initialized default process
    group of ``n`` ranks): ``{"data": n // model_parallel, "model":
    model_parallel}``; ``levels`` are the data axis's level sizes
    (``ProcessGroupWorkers``). Every rank must call it, with the same
    arguments: it creates every group of the grid."""
    n, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel}")
    W = n // model_parallel
    dp_parts, mp_parts = grid_ranks(W, model_parallel)
    data = ProcessGroupWorkers(levels, partition=dp_parts)
    model = (ProcessGroupWorkers(partition=mp_parts)
             if model_parallel > 1 else None)
    grid = ProcessGroupWorkers() if W > 1 and model_parallel > 1 else None
    return RankMesh(shape={"data": W, "model": model_parallel},
                    coords={"data": rank // model_parallel,
                            "model": rank % model_parallel},
                    rank=rank, data=data, model=model, grid=grid)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 chips a pod ``("data", "model")``; 2 pods with
    ``multi_pod``."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})
