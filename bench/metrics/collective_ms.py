"""Device time inside the worker group's collectives a step: the
aggregate's sum and OR, ZeRO-1's delta gathers, the loss mean."""

UNIT = "ms"


def read(run):
    return run["collective_ms"] / run["steps"] if run["collective_ms"] else None
