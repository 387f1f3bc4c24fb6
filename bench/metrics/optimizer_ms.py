"""Device time of the optimizer a step: the program's ``step/optimizer``
span (the grad norm, the clip, AdamW over every ZeRO-1 slice, the delta
gathers)."""

import program_spans

UNIT = "ms"


def read(run):
    return program_spans.span_ms(run, "step/optimizer")
