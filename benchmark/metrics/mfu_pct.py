"""Layer "model step": the traced stretch's share of the card's dense
bf16 peak.  The reference's FLOPs of one pair's encode and decode
(FlopCounterMode over the codec's programs at the cell's size, the
decoder's re-run of the conditioning included) times the pairs whose
work the stretch ran, over the stretch's seconds (the profiler's range
around it) times 989.4 TFLOP/s."""

from benchmark import peaks


def read(ctx):
    lo, hi = ctx["trace"]["window"]
    flops = ctx["flops_per_pair"] * ctx["traced_pairs"]
    return 100.0 * flops / ((hi - lo) / 1e6 * peaks.PEAK_BF16_FLOPS)
