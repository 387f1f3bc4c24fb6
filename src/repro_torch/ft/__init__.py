"""Fault tolerance: failure injection and detection, stragglers, the
switch's timeout and retransmit policy (with its per-shard view), and
elastic sizing."""
from .failures import (FailureSimulator, InjectedFailure, RecoveryPolicy,
                       ShardRetransmitView, StragglerMonitor,
                       SwitchRetransmitPolicy, SwitchStragglerTimeout,
                       elastic_data_parallel, elastic_mesh)
__all__ = ["FailureSimulator", "InjectedFailure", "RecoveryPolicy",
           "ShardRetransmitView", "StragglerMonitor",
           "SwitchRetransmitPolicy", "SwitchStragglerTimeout",
           "elastic_data_parallel", "elastic_mesh"]
