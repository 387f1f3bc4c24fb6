"""Elastic client: sparsify + error feedback + compress, re-encode on
renegotiation.

The client side of the round protocol:

1. ``propose(contract, grads)``: per-leaf top-k with error feedback
   (:func:`repro_torch.core.aggregators.sparsify_leaf`, the fixed-group
   aggregators' own, so the residual semantics are theirs), pack through
   the shared :class:`~repro_torch.core.bucketing.BucketPlan` geometry,
   and one fused producer pass (``compress_wire``: row 1 of the kernel
   table on the card). On the fxp32 wire this returns the client's
   :class:`ExponentProposal`, the per-bucket exponents from the
   producer's per-block maxima (a max of maxima is exact); the f32 wire
   has no phase A and returns ``None``.
2. ``payload(contract, shared_exponents)``: stamp the cached sketch with
   the round contract; fxp32 quantizes the cached f32 sketch against the
   sealed shared exponents through ``FixedPointWire.encode`` (a
   sketch-sized op, as the reference's quantize after the exponent max).

Error feedback is applied once, at ``propose``: the sparsified values
reach the aggregate, on time or through the server's deferred residual,
so the residual is not charged again if the round closes before this
client lands. ``reencode(new_contract)`` re-stamps the cached payload
under a new contract without touching error feedback: the recovery move
after a :class:`StaleContractError`.

Gradients are a nested dict of arrays or tensors (the flatten order is
``repro_torch.models.params.flatten_tree``'s, the reference's), moved to
the client's ``device``; the payload stays there.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.aggregators import sparsify_leaf
from repro_torch.core.bucketing import make_bucket_plan
from repro_torch.core.compressor import HomomorphicCompressor
from repro_torch.core.config import CompressionConfig
from repro_torch.models.params import flatten_tree, unflatten_tree

from .membership import (ClientPayload, ExponentProposal, RoundContract,
                         StaleContractError)


def tree_leaves(tree: Any):
    """(paths, leaves) of a nested dict in the reference's flatten order."""
    items = flatten_tree(tree)
    return tuple(p for p, _ in items), [v for _, v in items]


class ElasticClient:
    """One intermittent training client, computing on ``device``."""

    def __init__(self, client: int, cfg: CompressionConfig, device="cuda"):
        self.client = int(client)
        self.cfg = cfg
        self.device = torch.device(device)
        self.comp = HomomorphicCompressor(cfg)
        self._plan = None
        self._paths = None
        self._residual = None        # flat f32 leaves (error feedback)
        self._cache = None           # dict: one encoded round payload

    # ------------------------------------------------------------------

    @property
    def residual(self):
        """The per-leaf error-feedback residual as a nested dict (None
        before the first propose)."""
        if self._plan is None or self._residual is None:
            return None
        return unflatten_tree([(p, r.reshape(sh)) for p, r, sh in zip(
            self._paths, self._residual, self._plan.shapes)])

    def _check_geometry(self, contract: RoundContract) -> None:
        p = self._plan
        if (p.n_buckets, p.bucket_elems, p.total) != \
                (contract.n_buckets, contract.bucket_elems,
                 contract.total_elems):
            raise ValueError(
                f"client plan ({p.n_buckets}x{p.bucket_elems}/{p.total}) "
                f"does not match contract geometry "
                f"({contract.n_buckets}x{contract.bucket_elems}"
                f"/{contract.total_elems})")

    # ---- phase A ------------------------------------------------------

    def propose(self, contract: RoundContract,
                grads: Any) -> Optional[ExponentProposal]:
        """Sparsify (with error feedback), compress, cache the wire
        payload; fxp32 returns the exponent proposal for the server's
        max-fold."""
        paths, leaves = tree_leaves(grads)
        if self._plan is None:
            self._plan = make_bucket_plan(leaves, self.cfg)
            self._paths = paths
        elif paths != self._paths:
            raise ValueError("gradient tree does not match the client's "
                             "first tree")
        self._check_geometry(contract)
        plan = self._plan
        if self._residual is None:
            self._residual = [torch.zeros((n,), dtype=torch.float32,
                                          device=self.device)
                              for n in plan.sizes]
        sparse, new_res = [], []
        for leaf, res in zip(leaves, self._residual):
            flat = torch.as_tensor(leaf).to(
                device=self.device, dtype=torch.float32).reshape(-1)
            sp, nr = sparsify_leaf(flat, res, self.cfg)
            sparse.append(sp)
            new_res.append(nr)
        self._residual = new_res
        stream = plan.pack_flat(sparse)
        del sparse
        comp, maxabs = self.comp.compress_wire(stream.reshape(-1))
        self._cache = {
            "contract_id": contract.contract_id,
            "sketch": comp.sketch,               # f32, before quantizing
            "index_words": comp.index_words,
            "bucket_max": maxabs.reshape(plan.n_buckets, -1).amax(dim=1),
        }
        return self._proposal_from_cache(contract)

    def reencode(self, contract: RoundContract
                 ) -> Optional[ExponentProposal]:
        """Re-stamp the cached payload under a new contract; error
        feedback is not applied again (the sparsified values were never
        delivered, so the residual charged at ``propose`` stands). The
        fxp32 proposal is derived again from the cached maxima under the
        new cohort's wire, which re-prices the mantissa budget."""
        if self._cache is None:
            raise StaleContractError(
                f"client {self.client} has nothing to re-encode — call "
                "propose() first")
        self._check_geometry(contract)
        self._cache["contract_id"] = contract.contract_id
        return self._proposal_from_cache(contract)

    def _proposal_from_cache(self, contract: RoundContract
                             ) -> Optional[ExponentProposal]:
        if contract.wire_dtype != "fxp32":
            return None
        exps = contract.wire.exponents_from_maxabs(
            self._cache["bucket_max"]).to(torch.int32)
        return ExponentProposal(client=self.client,
                                contract_id=contract.contract_id,
                                exponents=exps)

    # ---- phase B ------------------------------------------------------

    def payload(self, contract: RoundContract,
                shared_exponents: Optional[torch.Tensor] = None
                ) -> ClientPayload:
        """The wire payload for the round; fxp32 quantizes the cached f32
        sketch against the sealed shared exponents."""
        if self._cache is None:
            raise StaleContractError(
                f"client {self.client} must propose() before payload()")
        if self._cache["contract_id"] != contract.contract_id:
            raise StaleContractError(
                f"client {self.client}'s cached payload was encoded "
                f"under {self._cache['contract_id']}, round is "
                f"{contract.contract_id} — reencode() first")
        sk = self._cache["sketch"]
        if contract.wire_dtype == "fxp32":
            if shared_exponents is None:
                raise ValueError("fxp32 payload needs the sealed shared "
                                 "exponents")
            exps = torch.as_tensor(shared_exponents).to(
                device=self.device, dtype=torch.int32)
            q = contract.wire.encode(sk.reshape(contract.n_buckets, -1),
                                     exps).reshape(sk.shape)
            return ClientPayload(
                client=self.client, contract_id=contract.contract_id,
                sketch=q, index_words=self._cache["index_words"],
                exponents=exps)
        return ClientPayload(
            client=self.client, contract_id=contract.contract_id,
            sketch=sk, index_words=self._cache["index_words"])

    def payload_stripes(self, contract: RoundContract, n_shards: int,
                        shared_exponents: Optional[torch.Tensor] = None
                        ) -> list:
        """Client-side striping for a sharded aggregation point: the round
        payload split into per-shard sub-payloads (views), so each stripe
        can go straight to the shard that owns its bucket range. The
        split is the server's own :func:`repro_torch.elastic.shard.stripe_payload`
        over :func:`repro_torch.elastic.shard.shard_ranges`."""
        from .shard import shard_ranges, stripe_payload
        p = self.payload(contract, shared_exponents)
        return stripe_payload(
            p, contract, shard_ranges(contract.n_buckets, n_shards),
            contract.bucket_elems // self.cfg.block_elems,
            contract.bucket_elems // 32)

    def contribute(self, contract: RoundContract, grads: Any
                   ) -> ClientPayload:
        """f32 convenience: propose + payload in one call (the f32 wire
        has no exponent phase to wait on)."""
        if contract.wire_dtype != "f32":
            raise ValueError(
                "contribute() is the single-phase f32 path; fxp32 "
                "rounds go propose() -> seal -> payload()")
        self.propose(contract, grads)
        return self.payload(contract)
