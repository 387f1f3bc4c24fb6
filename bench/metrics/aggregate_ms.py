"""Device time of the aggregation a step: the program's
``step/aggregate`` span around the aggregator's call (sparsify and
pack, encode, the sum and OR, peel, unpack and mean)."""

import program_spans

UNIT = "ms"


def read(run):
    return program_spans.span_ms(run, "step/aggregate")
