"""The fused consumer's least time (its bytes at the HBM rate, each
input read once and each output written once) over its device time,
summed over its launches in the profiled stretch."""

import yardstick as ys

UNIT = "%"


def read(run):
    return ys.kernel_roofline_pct(run, "wire_peel_kernel", "consumer")
