"""Bytes one worker hands the worker group's reductions a step: the
aggregate's sketch SUM and bitmap-word OR, and a few scalars (the mean
of the step's loss and its terms); counted by the benchmark's group from
the payloads the program passes it."""

UNIT = "B"


def read(run):
    return run["wire_bytes"] / run["steps"] if run["wire_bytes"] else None
