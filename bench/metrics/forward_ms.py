"""Device time inside the calls of the model's loss a step (every
worker's forward; the remat recompute runs in the backward, outside)."""

UNIT = "ms"


def read(run):
    return run["forward_ms"] / run["steps"] if run["forward_ms"] else None
