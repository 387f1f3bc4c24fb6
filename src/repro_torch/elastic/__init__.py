"""Elastic aggregation service: async sketch-fold for intermittent
many-client training.

The fixed-group aggregators (``core/aggregators.py``) assume W workers
that all arrive at the collective together. This package is the
parameter-server-shaped tier for an open population of clients whose
payloads fold into an aggregation point as they arrive, which the
paper's homomorphic wire allows without barriers and without decoding:

- :mod:`repro_torch.elastic.membership`: the roster and the per-round
  :class:`RoundContract` handshake; membership changes renegotiate the
  wire each round (the fxp32 mantissa budget is ``30 - ceil_log2(W)``),
  and stale-contract payloads are rejected or re-encoded, never silently
  folded.
- :mod:`repro_torch.elastic.fold`: the incremental fold (sketch add,
  bitmap OR, contribution counter; O(1) state in the cohort size),
  walked in ``SwitchModel`` slot-pool windows with the int32 register
  check on fxp32, recovered through one consumer call.
- :mod:`repro_torch.elastic.server` / :mod:`repro_torch.elastic.client`:
  round orchestration (admission, quorum/deadline close-out, straggler
  timeout and retransmit through ``ft/failures.py``, late payloads
  carried into the next round's residual) and the client's sparsify,
  error feedback and producer pass.
- :mod:`repro_torch.elastic.shard`: the scale-out fold,
  :class:`ShardedFoldService`: contiguous shard ranges, striped payloads,
  microbatched combines, and f32 folds reduced in canonical
  client-sorted order.

Everything here is the reference's ``repro.elastic`` on tensors of the
service's device: the client runs the fused producer (row 1 of the
kernel table), the close and each deferred payload the fused consumer
(row 2 on f32, row 4 with the fxp32 dequant), one launch a shard.
"""

from .membership import (ClientPayload, ExponentProposal, Membership,
                         RoundContract, StaleContractError,
                         negotiate_contract)
from .fold import FoldEngine, FoldError, FoldState
from .shard import (ShardRange, ShardedFoldService, ShardedFoldState,
                    shard_contract, shard_ranges, stripe_payload)
from .client import ElasticClient
from .server import (AdmissionPolicy, ElasticServer, QuorumNotReached,
                     RoundReport)

__all__ = [
    "AdmissionPolicy", "ClientPayload", "ElasticClient", "ElasticServer",
    "ExponentProposal", "FoldEngine", "FoldError", "FoldState",
    "Membership", "QuorumNotReached", "RoundContract", "RoundReport",
    "ShardRange", "ShardedFoldService", "ShardedFoldState",
    "StaleContractError", "negotiate_contract", "shard_contract",
    "shard_ranges", "stripe_payload",
]
