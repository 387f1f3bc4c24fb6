"""Fault tolerance: the switch's straggler timeout and retransmit
policy. Failure injection, straggler monitors and elastic re-meshing come
with the fault-tolerance and elastic slices."""
