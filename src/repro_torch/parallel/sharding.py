"""Parameter / activation / cache partition rules, the reference's
``parallel/sharding.py`` as plain data.

Megatron-style tensor parallelism on the ``model`` axis, expert
parallelism on a configurable axis set, vocab-sharded embeddings, and
shape-dependent cache sharding for serving. A spec is a tuple with one
entry a dim: ``None`` (replicated), an axis name, or a tuple of axis
names (rank-major, the first outermost); the counterpart of the
reference's ``PartitionSpec``. A mesh is its shape, a dict of axis
sizes such as ``{"data": 2, "model": 2}``.

Rules are path-based: the leaf's own name plus its parent module name
select the spec, so one table covers dense layers, MoE experts, Mamba
blocks and the hybrid ``pos{i}`` nesting.

:func:`local_shape`, :func:`shard_leaf` and :func:`gather_leaf` go
between a whole leaf and the shard a rank of the grid holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingProfile:
    """Per-architecture distribution choices (the reference's)."""
    dp_axes: Tuple[str, ...] = ("pod", "data")   # gradient-aggregation axes
    tp_axis: Optional[str] = "model"             # None: params replicated
    ep_axes: Tuple[str, ...] = ("model",)        # expert dim of MoE weights
    ep_ff_axis: Optional[str] = None             # extra axis on expert d_ff
    vocab_axis: Optional[str] = "model"
    zero1: bool = True                           # shard optimizer state on dp
    batch_auto_axes: Tuple[str, ...] = ()        # batch sharded on auto axes

    def logical_rules(self, inside_manual_dp: bool) -> dict:
        """The logical-axis mapping of the activation hints."""
        if inside_manual_dp:
            dp = (self.batch_auto_axes if len(self.batch_auto_axes) > 1 else
                  (self.batch_auto_axes[0] if self.batch_auto_axes else None))
        else:
            all_dp = tuple(self.dp_axes) + tuple(self.batch_auto_axes)
            dp = all_dp if len(all_dp) > 1 else (all_dp[0] if all_dp else None)
        return {
            "dp": dp,
            "tp": self.tp_axis,
            "ep": self.ep_axes if len(self.ep_axes) > 1 else self.ep_axes[0],
            "sp": self.tp_axis or "model",
        }


# ----------------------------------------------------------------------
# Parameter rules
# ----------------------------------------------------------------------

def _leaf_spec(path: Tuple[str, ...], ndim: int, prof: ShardingProfile,
               stacked: bool) -> Spec:
    """Spec for one parameter leaf of ``ndim`` dims; ``stacked``: it has
    a leading layer dim."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    tp = prof.tp_axis
    lead: Tuple = (None,) if stacked else ()

    def spec(*parts):
        return lead + parts

    # embeddings / head (never layer-stacked)
    if name == "embed":
        return (prof.vocab_axis, None)
    if name == "lm_head":
        return (None, prof.vocab_axis)

    if parent in ("attn", "xattn"):
        if name in ("wq", "wk", "wv"):
            return spec(None, tp)
        if name == "wo":
            return spec(tp, None)
        if name in ("bq", "bk", "bv"):
            return spec(tp)

    # dense FFN (and the MoE's shared experts)
    if parent in ("ffn", "mlp", "shared"):
        if name in ("w_gate", "w_up"):
            return spec(None, tp)
        if name == "w_down":
            return spec(tp, None)

    if name == "router":
        return spec(None, None)
    if name in ("we_gate", "we_up", "we_down"):
        ep = prof.ep_axes if len(prof.ep_axes) > 1 else prof.ep_axes[0]
        if name == "we_down":
            return spec(ep, prof.ep_ff_axis, None)
        return spec(ep, None, prof.ep_ff_axis)

    if parent == "mamba":
        if name in ("wx", "wz", "wdt"):
            return spec(None, tp)
        if name == "wo":
            return spec(tp, None)
        if name in ("A_log", "D_skip", "dt_bias"):
            return spec(tp)
        if name in ("wB", "wC", "conv_w", "conv_b"):
            return spec(*(None,) * (ndim - len(lead)))

    # norms / scalars: replicated
    return spec(*(None,) * (ndim - len(lead)))


_STACKED_ROOTS = ("layers", "superblocks", "enc_layers", "dec_layers")


def leaf_spec(path: Sequence[str], ndim: int, prof: ShardingProfile) -> Spec:
    """The spec of the leaf at ``path`` (its keys from the root)."""
    path = tuple(path)
    stacked = any(n in _STACKED_ROOTS for n in path)
    return _leaf_spec(path, ndim, prof, stacked)


def param_pspecs(params: Dict[str, Any], prof: ShardingProfile) -> Dict:
    """The spec tree matching ``params``, a nested dict of tensors (or of
    anything with ``ndim``)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_spec(path, node.ndim, prof)
    return walk(params, ())


def param_shardings(params: Dict[str, Any], prof: ShardingProfile,
                    mesh_shape: Mapping[str, int]) -> Dict:
    """What a device of the mesh holds of each leaf of ``params`` (the
    reference's ``NamedSharding`` tree): its local shape under
    :func:`param_pspecs`."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return local_shape(tuple(node.shape), spec, mesh_shape)
    return walk(params, param_pspecs(params, prof))


def filter_rules_for_mesh(rules: dict, mesh_shape: Mapping[str, int]) -> dict:
    """Drop logical-rule axes the mesh doesn't have (e.g. ``pod`` on a
    single-pod mesh)."""
    def keep(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            kept = tuple(a for a in v if a in mesh_shape)
            return kept if kept else None
        return v if v in mesh_shape else None
    return {k: keep(v) for k, v in rules.items()}


def strip_axes(spec: Spec, axes: Sequence[str]) -> Spec:
    """``spec`` with every reference to ``axes`` removed."""
    drop = set(axes)
    parts = []
    for s in spec:
        if s is None:
            parts.append(None)
        elif isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a not in drop)
            parts.append(kept if kept else None)
        else:
            parts.append(None if s in drop else s)
    return tuple(parts)


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape a device holds of a leaf of ``shape`` sharded as
    ``spec`` (the reference's ``core/aggregators._local_shape``)."""
    def div(i):
        d = 1
        for nm in _axes(spec[i] if i < len(spec) else None):
            d *= mesh_shape[nm]
        return d
    return tuple(sz // div(i) for i, sz in enumerate(shape))


def _block_index(part, mesh_shape, coords) -> int:
    idx = 0
    for nm in _axes(part):
        idx = idx * mesh_shape[nm] + coords[nm]
    return idx


def shard_leaf(full: torch.Tensor, spec: Spec, mesh_shape: Mapping[str, int],
               coords: Mapping[str, int]) -> torch.Tensor:
    """The block of ``full`` that the device at ``coords`` holds under
    ``spec`` (a view; every sharded dim must divide by its axes' size)."""
    out = full
    for i, part in enumerate(spec):
        n = 1
        for nm in _axes(part):
            n *= mesh_shape[nm]
        if n == 1:
            continue
        if full.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(full.shape)} does not split "
                             f"over {n} shards ({part!r})")
        blk = full.shape[i] // n
        out = out.narrow(i, _block_index(part, mesh_shape, coords) * blk, blk)
    return out


def gather_leaf(local: torch.Tensor, spec: Spec, group,
                axis: str = "model") -> torch.Tensor:
    """The inverse of :func:`shard_leaf` over one axis: the shards of the
    ranks of ``group`` (that axis's process group, in index order)
    concatenated on the dim ``spec`` shards by ``axis``; ``local`` where
    no dim is. Every rank of ``group`` must call it together."""
    for i, part in enumerate(spec):
        if axis in _axes(part):
            if len(_axes(part)) > 1:
                raise ValueError(f"dim {i} is sharded over {part!r}; only "
                                 f"{axis!r} is gathered")
            if group is None or group.workers == 1:
                return local
            return group.gather([local.movedim(i, 0).contiguous()]
                                ).movedim(0, i)
    return local


# ----------------------------------------------------------------------
# Batch / cache specs per serving shape
# ----------------------------------------------------------------------

def _dp_size(mesh_shape: Mapping[str, int]) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= mesh_shape.get(a, 1)
    return n


def batch_pspec(global_batch: int, mesh_shape: Mapping[str, int],
                prof: ShardingProfile) -> Spec:
    """Batch-dim sharding: all DP axes the batch can cover."""
    covered, size = [], 1
    for a in ("pod", "data"):
        if a in mesh_shape and global_batch % (size * mesh_shape[a]) == 0:
            covered.append(a)
            size *= mesh_shape[a]
    return (tuple(covered),) if covered else ()


def cache_pspecs(cfg, global_batch: int, mesh_shape: Mapping[str, int],
                 prof: ShardingProfile) -> Dict[str, Any]:
    """Specs for the decode cache tree (``init_cache``'s layout).

    Large batch: the batch over the DP axes, the sequence over the TP
    axis (sequence-parallel KV). Batch below the DP size (long context):
    the sequence over every axis."""
    dp = batch_pspec(global_batch, mesh_shape, prof)
    dp_names = dp[0] if len(dp) else None
    if global_batch >= _dp_size(mesh_shape):
        b_ax, s_ax = dp_names, prof.tp_axis
    else:
        b_ax, s_ax = None, tuple(mesh_shape)

    kv = (None, b_ax, s_ax, None, None)             # (L, B, S, KV, hd)

    def mamba_state(extra_lead: int):
        lead = (None,) * extra_lead
        return {"ssm": lead + (b_ax, prof.tp_axis, None, None),
                "conv": lead + (b_ax, None, None)}

    if cfg.family == "ssm":
        return {"ssm": mamba_state(1)}
    if cfg.family == "hybrid":
        return {"mamba": mamba_state(2), "kv": {"k": kv, "v": kv}}
    if cfg.family == "encdec":
        return {"k": kv, "v": kv,
                "xk": (None, b_ax, None, None, None),
                "xv": (None, b_ax, None, None, None)}
    return {"k": kv, "v": kv}
