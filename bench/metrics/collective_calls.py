"""Calls into the worker group's collectives a step, every op: the
program's ``collective/calls/*`` counters (the aggregate's sum and OR,
the loss mean, one ZeRO-1 delta gather a sliced leaf)."""

import program_spans

UNIT = "calls"


def read(run):
    return program_spans.counter_per_step(run, "collective/calls/")
