"""Device time of the backward a step, the block recompute included:
every local worker's ``step/backward`` span of the program's tracer."""

import program_spans

UNIT = "ms"


def read(run):
    return program_spans.span_ms(run, "step/backward")
