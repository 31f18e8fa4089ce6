"""Layer "device": the share of the traced stretch in which the device
ran nothing, the stretch's wall time minus the union of kernels and
copies over every stream, over the wall time."""

from benchmark import profiling


def read(ctx):
    lo, hi = ctx["trace"]["window"]
    return 100.0 * (1 - profiling.busy_us(ctx["trace"]) / (hi - lo))
