"""The model axis as the layers see it: logical activation hints, the
bound model-axis group, and the tensor-parallel collectives.

The reference's ``constrain(x, ("dp", None, "tp"))`` maps logical axis
names onto mesh axes for GSPMD, and is a no-op when no mapping is active
(the single-device CPU path). The port's layout is explicit instead:
each rank holds its shards and the layers compute on them, so a hint
places nothing and :func:`constrain` returns its input.

:func:`model_region` binds the model-axis group (the ranks of one
data-parallel index, a ``ProcessGroupWorkers``); inside it the layers
call Megatron's two conjugate functions:

- :func:`copy_to_model`: identity forward, all-reduce of the gradient
  backward (before a column-parallel product, whose input every model
  rank reads whole);
- :func:`reduce_from_model`: all-reduce forward, identity backward
  (after a row-parallel product, whose output is a partial sum);

and the vocab-parallel ends: :func:`vocab_embed`, a lookup of the rows
this rank holds, and :func:`vocab_parallel_lse`, the ``logsumexp`` and
label logit over the vocab shards. Three more carry the layouts whose
shards are not a plain column or row split:

- :func:`sum_over_model`: all-reduce forward *and* backward, for a
  reduction whose total every shard's output depends on (the Mamba
  mixer's gated RMSNorm over the whole ``d_inner``);
- :func:`gather_from_model`: the model ranks' column slices of the last
  dim concatenated, its backward the reduce-scatter of the whole
  gradient (the K/V projections where MP does not divide the KV heads);
- :func:`copy_to_model` on several tensors at once (replicated leaves
  used shard-locally), their gradients summed in one all-reduce a dtype.

``model_region(group, experts=data)`` also binds the data-parallel group
that the routed experts are split over (kimi-k2's profile, experts on the
``data`` axis): :func:`expert_group`, and the token all-gather
:func:`gather_rows` / reduce-scatter :func:`scatter_rows` around the
layer, over :func:`row_group`: the ranks whose token rows a MoE layer
routes as one batch (``rows``; by default the experts' group). Serving
(``serve/steps.py``) binds ``rows`` to the group its batch is split
over, since the reference routes a serve step's whole batch, and
``seq`` to the group its KV cache's sequence is split over
(:func:`seq_group`, read by ``layers.attention_decode`` and the
prefill's cache). Outside a region (or in a region of one rank) every
one of them is the identity or the unsharded form, so every
single-rank path computes what it computed before.

The binding is a module global, not a thread-local: a checkpointed
block's recompute runs on autograd's device thread for CUDA tensors, and
must see the group the forward saw. Run the backward inside the region
too. The all-reduces sum in the payload's dtype (bf16 on the card; gloo
sums bf16).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

_GROUP = None
_EXPERTS = None
_ROWS = None
_SEQ = None


def _bound(group):
    return group if group is not None and group.workers > 1 else None


@contextlib.contextmanager
def model_region(group, experts=None, rows=..., seq=None):
    """Bind ``group`` (the model-axis process group, or None) as the
    model axis for the layers, ``experts`` (a data-parallel group, or
    None) as the axis the routed experts are split over, ``rows`` (by
    default ``experts``) as the ranks whose token rows a MoE layer
    gathers and routes as one batch, and ``seq`` as the ranks the decode
    cache's sequence is split over (rank-major: its rank index is its
    block's); a group of one binds nothing."""
    global _GROUP, _EXPERTS, _ROWS, _SEQ
    prev = _GROUP, _EXPERTS, _ROWS, _SEQ
    _GROUP, _EXPERTS = _bound(group), _bound(experts)
    _ROWS = _EXPERTS if rows is ... else _bound(rows)
    _SEQ = _bound(seq)
    try:
        yield
    finally:
        _GROUP, _EXPERTS, _ROWS, _SEQ = prev


def model_group():
    """The bound model-axis group, or None outside a region."""
    return _GROUP


def expert_group():
    """The bound data-parallel group of the routed experts, or None."""
    return _EXPERTS


def row_group():
    """The bound group whose ranks' token rows a MoE layer routes as one
    batch, or None."""
    return _ROWS


def seq_group():
    """The bound group the decode cache's sequence is split over, or
    None."""
    return _SEQ


def model_index() -> int:
    """This rank's index on the model axis (0 outside a region)."""
    return 0 if _GROUP is None else _GROUP.first_worker


def constrain(x: torch.Tensor, logical_spec) -> torch.Tensor:
    """The reference's activation hint: ``x`` itself (the port's shards
    are explicit, so there is nothing to place)."""
    del logical_spec
    return x


class _CopyToModel(torch.autograd.Function):
    """Identity on each tensor; backward, the gradients summed over the
    group, those of one dtype flattened into one all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        for dtype in dict.fromkeys(g.dtype for g in gs):
            idx = [i for i, g in enumerate(gs) if g.dtype == dtype]
            flat = torch.cat([gs[i].reshape(-1) for i in idx])
            total = ctx.group.sum([flat])
            for i, part in zip(idx, total.split([gs[i].numel() for i in idx])):
                out[i] = part.view_as(gs[i])
        return (None, *out)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.sum([x.contiguous()])

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(*xs: torch.Tensor):
    """Identity; the gradient is summed over the model axis. One tensor
    in, one out; several in, a tuple out (their gradients summed in one
    all-reduce a dtype)."""
    if _GROUP is not None:
        xs = _CopyToModel.apply(_GROUP, *xs)
    return xs[0] if len(xs) == 1 else tuple(xs)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model axis; its gradient passes as is."""
    return x if _GROUP is None else _ReduceFromModel.apply(x, _GROUP)


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.sum([x.contiguous()])

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum([g.contiguous()]), None


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model axis, its gradient summed too: for
    a total that every rank's shard goes on to use (each rank's share of
    the loss depends on it, so the true gradient of each rank's term is
    the sum of all ranks' gradients of the total)."""
    return x if _GROUP is None else _SumBoth.apply(x, _GROUP)


class _Gather(torch.autograd.Function):
    """The group's slices of dim ``dim`` concatenated in rank order;
    backward, the whole gradient reduce-scattered back to the slices (the
    sum over the ranks, then this rank's slice: the ring reduce-scatter,
    ``ProcessGroupWorkers.sum_scatter``)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.gather([x.movedim(dim, 0).contiguous()]).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        part = ctx.group.sum_scatter([g.movedim(ctx.dim, 0).contiguous()])[0]
        return part.movedim(0, ctx.dim), None, None


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x``'s last dim whole: every model rank's column slice of it, in
    rank order; the gradient of each slice is the sum over the ranks of
    their gradients of it."""
    return x if _GROUP is None else _Gather.apply(x, _GROUP, -1)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.sum_scatter([x.contiguous()])[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.group.gather([g.contiguous()]), None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0) over :func:`row_group`, in rank
    order; backward, each rank's rows get the sum of every rank's
    gradient of them."""
    return x if _ROWS is None else _Gather.apply(x, _ROWS, 0)


def scatter_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``x`` (dim 0, the group's rows in rank order)
    summed over :func:`row_group` (the ring reduce-scatter); backward,
    the all-gather of the rows' gradients."""
    return x if _ROWS is None else _ScatterRows.apply(x, _ROWS)


class _WireSum(torch.autograd.Function):
    """The sum over the model axis carried by an expert-parallel
    exchange: forward, the exchange's merged token blocks gathered back
    to ``(T, D)``; backward, the identity to the partial (the conjugate
    of the sum, as :func:`reduce_from_model`)."""

    @staticmethod
    def forward(ctx, partial, exchange):
        group = exchange.group
        T, D = partial.shape
        W = group.workers
        blk = -(-T // W)
        payload = torch.nn.functional.pad(partial, (0, 0, 0, W * blk - T))
        merged = exchange([[payload.reshape(W, blk, D)]])
        return group.gather([merged[0][0]])[:T]

    @staticmethod
    def backward(ctx, g):
        return g, None


def exchange_sum(partial: torch.Tensor, exchange) -> torch.Tensor:
    """``partial`` (T, D) summed over ``exchange``'s group by the
    exchange's wire (token block r merged at rank r, then gathered)."""
    return _WireSum.apply(partial, exchange)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` with ``table`` this rank's rows of the padded
    vocab (``[t·n, (t+1)·n)``): the rows it holds looked up, zeros for
    the rest, summed over the model axis."""
    if _GROUP is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens - model_index() * n
    inside = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return reduce_from_model(x)


class _VocabParallelLse(torch.autograd.Function):
    """(lse, label logit) of logits split by columns over the model
    axis: the max all-reduced, then the sums of ``exp(l - max)`` and the
    owning shard's label logit in one all-reduce. Backward:
    ``softmax_local · d_lse + onehot_local · d_ll``."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        n = logits.shape[-1]
        m = group.max([logits.amax(dim=-1)])
        local = labels - start
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        ll = torch.where(inside, logits.gather(-1, idx[..., None])[..., 0],
                         torch.zeros((), dtype=logits.dtype,
                                     device=logits.device))
        s = torch.exp(logits - m[..., None]).sum(dim=-1)
        s, ll = group.sum([torch.stack([s, ll])]).unbind(0)
        lse = m + torch.log(s)
        ctx.save_for_backward(logits, lse, idx, inside)
        return lse, ll

    @staticmethod
    def backward(ctx, d_lse, d_ll):
        logits, lse, idx, inside = ctx.saved_tensors
        g = torch.exp(logits - lse[..., None]) * d_lse[..., None]
        g = g.scatter_add(-1, idx[..., None],
                          (d_ll * inside.to(d_ll.dtype))[..., None])
        return g, None, None, None


def vocab_parallel_lse(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logsumexp(logits), logits[label])`` over the whole vocab, where
    ``logits`` are this rank's columns of it (f32)."""
    if _GROUP is None:
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels[..., None].long())[..., 0])
    start = model_index() * logits.shape[-1]
    return _VocabParallelLse.apply(logits, labels.long(), start, _GROUP)
