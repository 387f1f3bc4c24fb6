"""Device time a step of every local worker's f32 cast, error feedback,
exact top-k, residual write and pack: the program's
``aggregate/sparsify`` span."""

import program_spans

UNIT = "ms"


def read(run):
    return program_spans.span_ms(run, "aggregate/sparsify")
