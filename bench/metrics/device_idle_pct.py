"""Share of the profiled stretch in which no kernel, copy or set ran on
the card."""

UNIT = "%"


def read(run):
    prof = run.get("profile")
    if not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
